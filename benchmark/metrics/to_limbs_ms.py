"""to_limbs_ms: per proof, the host's conversion of Python ints to limbs
inside the prover walk (the program's `limbs.to_limbs` spans inside its
`walk` spans: `limbs.pack`'s bytes join, before the upload), over the
`walk` spans.  From the program's spans (`gkr_tpu_torch.tracing`); a
program without them gives nothing."""


def read(run):
    if run.kind != "proofs" or run.trace is None:
        return None
    try:
        from gkr_tpu_torch import tracing
    except ImportError:
        return None
    walks = tracing.totals().get("walk")
    pack = tracing.totals(within="walk").get("limbs.to_limbs")
    if walks is None or pack is None:
        return None
    return 1e3 * pack.seconds / walks.calls
