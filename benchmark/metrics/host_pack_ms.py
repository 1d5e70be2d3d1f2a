"""host_pack_ms: per proof, the time of the prover's pass-1 upload of
every layer's table (the backend's `packed`, from Python ints to limbs on
the card, ending in a synchronize), from the benchmark's span."""


def read(run):
    s = run.spans.per_request("pack")
    return 1e3 * sum(s) / len(s) if s else None
