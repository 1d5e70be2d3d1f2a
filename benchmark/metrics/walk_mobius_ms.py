"""walk_mobius_ms: per proof, the host time of the prover walk's pass-1
Moebius transforms and struct scalars (the program's `walk.mobius` spans,
one a layer: the launches of each table's transform and its reduction to
support, degree and emptiness, no sync), over the `walk` spans.  From the
program's spans (`gkr_tpu_torch.tracing`); a program without them gives
nothing."""


def read(run):
    if run.kind != "proofs" or run.trace is None:
        return None
    try:
        from gkr_tpu_torch import tracing
    except ImportError:
        return None
    spans = tracing.totals()
    if "walk" not in spans or "walk.mobius" not in spans:
        return None
    return 1e3 * spans["walk.mobius"].seconds / spans["walk"].calls
