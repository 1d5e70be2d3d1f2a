"""sparse_form_ms: per proof, the time of the sparse monomial forms of the
output and input tables (the backend's `sparse_from_dense`, ending in a
synchronize), from the benchmark's span."""


def read(run):
    s = run.spans.per_request("sparse_form")
    return 1e3 * sum(s) / len(s) if s else None
