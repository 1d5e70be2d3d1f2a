"""walk_check_ms: per proof, the host time of the prover walk's checks
after its last download (the program's `walk.check` span: each layer's
re-hash, the r* re-hash, the z-chain compare and the interpolation of q),
over the `walk` spans.  From the program's spans (`gkr_tpu_torch.tracing`);
a program without them gives nothing."""


def read(run):
    if run.kind != "proofs" or run.trace is None:
        return None
    try:
        from gkr_tpu_torch import tracing
    except ImportError:
        return None
    spans = tracing.totals()
    if "walk" not in spans or "walk.check" not in spans:
        return None
    return 1e3 * spans["walk.check"].seconds / spans["walk"].calls
