"""walk_wait_ms: per proof, the host's time blocked on the card inside the
prover walk: the program's `fused.download` spans inside its `walk` spans
(pass 1's download of the struct scalars, then the one download of every
layer's arrays, each waiting for the work queued before it), over the
`walk` spans.  On a traced run the benchmark's `pack` span synchronizes
after each table's upload, so the wait holds the Moebius transforms and
pass 2, not the pack's device work.  From the program's spans
(`gkr_tpu_torch.tracing`); a program without them gives nothing."""


def read(run):
    if run.kind != "proofs" or run.trace is None:
        return None
    try:
        from gkr_tpu_torch import tracing
    except ImportError:
        return None
    walks = tracing.totals().get("walk")
    wait = tracing.totals(within="walk").get("fused.download")
    if walks is None or wait is None:
        return None
    return 1e3 * wait.seconds / walks.calls
