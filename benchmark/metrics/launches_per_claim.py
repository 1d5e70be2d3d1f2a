"""launches_per_claim: the program's kernel launches in the window (its
`kernels.LAUNCHES` counters) per claim."""


def read(run):
    n = len(run.requests)
    if run.kind != "layer_claims" or not n:
        return None
    return sum(run.launches.values()) / n
