"""prove_gates_per_s: the gates of every proof completed in the window over
the whole window, which closes at the end of the last proof it started."""


def read(run):
    if run.kind != "proofs":
        return None
    t0, t1 = run.window
    return sum(r.gates for r in run.requests if r.ok) / (t1 - t0)
