"""walk_line_ms: per proof, the host time of pass 2's line steps (the
program's `walk.line` spans, one a layer: r* hashed on the card, the
z-chain's next point and W~ at the line's points, enqueued with no sync),
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
    if "walk" not in spans or "walk.line" not in spans:
        return None
    return 1e3 * spans["walk.line"].seconds / spans["walk"].calls
