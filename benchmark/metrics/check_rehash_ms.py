"""check_rehash_ms: per claim, the host's re-hash in the layer's host check
(the program's `fused.rehash` span: each round's coefficients shaped and
hashed by the host's MiMC7), over the `fused.check` spans.  From the
program's spans (`gkr_tpu_torch.tracing`); a program without them gives
nothing."""


def read(run):
    if run.kind != "layer_claims" or run.trace is None:
        return None
    try:
        from gkr_tpu_torch import tracing
    except ImportError:
        return None
    spans = tracing.totals()
    if "fused.check" not in spans or "fused.rehash" not in spans:
        return None
    return 1e3 * spans["fused.rehash"].seconds / spans["fused.check"].calls
