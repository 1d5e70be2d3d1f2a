"""check_unpack_ms: per claim, the host's conversion of the downloaded
limbs to Python ints in the layer's host check (the program's
`limbs.from_limbs` spans inside its `fused.check` spans), over the
`fused.check` spans.  From the program's spans (`gkr_tpu_torch.tracing`);
a program without them gives nothing."""


def read(run):
    if run.kind != "layer_claims" or run.trace is None:
        return None
    try:
        from gkr_tpu_torch import tracing
    except ImportError:
        return None
    checks = tracing.totals().get("fused.check")
    unpack = tracing.totals(within="fused.check").get("limbs.from_limbs")
    if checks is None or unpack is None:
        return None
    return 1e3 * unpack.seconds / checks.calls
