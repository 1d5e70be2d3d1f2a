"""walk_enqueue_ms: per proof, the host time of the prover walk's pass 2
(the program's `walk.enqueue` span: every layer's fused sumcheck, the
z-chain and the line points enqueued on the card, no sync), over the
`walk` spans.  The program's spans (`gkr_tpu_torch.tracing`) record only
while the traced window's profiler runs; a program without them gives
nothing."""


def read(run):
    if run.kind != "proofs" or run.trace is None:
        return None
    try:
        from gkr_tpu_torch import tracing
    except ImportError:
        return None
    spans = tracing.totals()
    if "walk" not in spans or "walk.enqueue" not in spans:
        return None
    return 1e3 * spans["walk.enqueue"].seconds / spans["walk"].calls
