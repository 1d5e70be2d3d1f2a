"""launches_per_proof: the program's kernel launches in the window (its
`kernels.LAUNCHES` counters) per completed proof, on traced runs."""


def read(run):
    done = sum(r.ok for r in run.requests)
    if run.kind != "proofs" or run.trace is None or not done:
        return None
    return sum(run.launches.values()) / done
