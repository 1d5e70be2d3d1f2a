"""layer_gates_per_s: the gates of every layer claim answered in the
window over the whole window, which closes when the last claim it started
has passed its host check."""


def read(run):
    if run.kind != "layer_claims":
        return None
    t0, t1 = run.window
    return sum(r.gates for r in run.requests if r.ok) / (t1 - t0)
