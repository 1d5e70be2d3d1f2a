"""host_check_ms: the mean time of a claim's host check (`finish`: the
re-hash of every round and the transcript's checks), from the benchmark's
span around it."""


def read(run):
    s = run.spans.per_request("host_check")
    return 1e3 * sum(s) / len(s) if s else None
