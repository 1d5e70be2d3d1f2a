"""device_idle_pct.<cell kind>: the share of the traced window in which no
kernel, copy or fill ran on the card, in percent: 100 (1 - busy / window)
from the device trace.  One reader for every cell; `BENCHMARK.json` names
one metric for each end-to-end metric it moves."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
