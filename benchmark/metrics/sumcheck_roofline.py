"""sumcheck_roofline: the least time of one layer sumcheck on the card
(`counts.sumcheck.floor_s` of the claim's shape) over the card's busy time
per answered claim in the traced window (the union of its kernel, copy and
fill intervals, from the device trace), in percent."""

from benchmark.counts.sumcheck import floor_s


def read(run):
    if run.kind != "layer_claims" or run.trace is None:
        return None
    done = sum(r.ok for r in run.requests)
    if not done:
        return None
    floor, _ = floor_s(run.shape["n"], run.shape["gates"], run.shape["k_cur"])
    return 100.0 * floor * done / run.trace["busy_s"]
