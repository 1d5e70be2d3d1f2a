"""GKR prover: the per-layer walk driving the sumcheck engine.

Mirrors `rust/src/gkr/prover.rs:6-96` exactly at the protocol level:
  * z_0 = 0-vector of length k_0 (prover.rs:17-21; the Python prototype's
    random z_0 is available via z0; see SURVEY §5 footnote 1),
  * layers i = 0..depth-1 inclusive — the LAST sumcheck runs against the
    input layer (i+1 == depth, k(i+1) = input_k),
  * after each layer: b*/c* split of the challenges, q_i = W~_{i+1} ∘ l,
    r*_i = MiMC(last round coeffs), z_{i+1} = l(r*_i),
  * proof.depth = circuit depth + 1 (prover.rs:92).

The compute backend is pluggable: `TorchBackend` (tables on the CUDA card —
the default) or `HostBackend` (exact Python ints, only when passed
explicitly).  Both produce byte-identical transcripts.  Each call into the
backend runs under a `backend.<method>` span (`tracing`).
"""

from __future__ import annotations

from . import tracing
from .circuit import GKRCircuit
from .field import P
from .mimc import Mimc7
from .mle import line, mle_struct, restrict_to_line, sparse_from_dense
from .proof import Proof
from .sumcheck import prove_layer_sumcheck
from .torcheng.backend import TorchBackend


class HostBackend:
    """Exact host engine (Python big ints over dense tables)."""

    def mle_struct(self, w_values, layer_idx=None):
        return mle_struct(w_values)

    def layer_sumcheck(self, z, w_next, add_gates, mult_gates,
                       k_cur, k_next, w_struct, transcript, layer_idx=None):
        return prove_layer_sumcheck(z, w_next, add_gates, mult_gates,
                                    k_cur, k_next, w_struct, transcript)

    def restrict_to_line(self, w_values, b, c, struct, layer_idx=None):
        return restrict_to_line(w_values, b, c, struct)

    def sparse_from_dense(self, w_values):
        return sparse_from_dense(w_values)


def prove(circuit: GKRCircuit, w_values: list[list[int]],
          transcript: Mimc7 | None = None,
          z0: list[int] | None = None,
          backend=None,
          materialize_sparse: bool = True) -> Proof:
    """Prove the layered circuit given its value tables.

    `w_values` must be the full forward sweep [W_0..W_depth]
    (`circuit.evaluate(input)`); `w_values[0]` is the output vector D.
    `materialize_sparse=False` skips the (potentially huge) sparse MLE term
    lists `d`/`input_func` in the returned proof (benchmark mode; the
    reference always materializes them, convert.rs:840-847).
    """
    if transcript is None:
        transcript = Mimc7()
    if backend is None:
        backend = TorchBackend()
    if hasattr(backend, "reset_cache"):
        backend.reset_cache()
    depth = circuit.depth()
    assert len(w_values) == depth + 1

    z: list[list[int]] = [list(z0) if z0 is not None
                          else [0] * circuit.k(0)]
    sumcheck_proofs = []
    sumcheck_r = []
    q = []
    r_stars = []

    for i in range(depth):
        layer = circuit.layers[i]
        k_next = circuit.k(i + 1)
        w_next = w_values[i + 1]
        with tracing.span("backend.mle_struct"):
            struct = backend.mle_struct(w_next, layer_idx=i + 1)

        with tracing.span("backend.layer_sumcheck"):
            proof_i, r_i = backend.layer_sumcheck(
                z[i], w_next, layer.add_gates, layer.mult_gates,
                layer.k_cur, k_next, struct, transcript, layer_idx=i + 1)
        sumcheck_proofs.append(proof_i)
        sumcheck_r.append(r_i)

        b_star = r_i[:k_next]
        c_star = r_i[k_next:]
        with tracing.span("backend.restrict_to_line"):
            q_i = backend.restrict_to_line(w_next, b_star, c_star, struct,
                                           layer_idx=i + 1)
        q.append(q_i)

        r_star = transcript.multi_hash(proof_i[-1], 0)
        r_stars.append(r_star)
        z.append(line(b_star, c_star, r_star))

    if materialize_sparse:
        with tracing.span("backend.sparse_from_dense"):
            d_sparse = backend.sparse_from_dense(w_values[0])
        with tracing.span("backend.sparse_from_dense"):
            input_sparse = backend.sparse_from_dense(w_values[depth])
    else:
        d_sparse = []
        input_sparse = []

    return Proof(
        sumcheck_proofs=sumcheck_proofs,
        sumcheck_r=sumcheck_r,
        d=d_sparse,
        q=q,
        z=z,
        r=r_stars,
        depth=depth + 1,
        input_func=input_sparse,
        k=circuit.k_list(),
    )


def prove_from_input(circuit: GKRCircuit, input_values: list[int],
                     check_output_zero: bool = False, **kw) -> Proof:
    """Convenience: forward sweep + prove.  When `check_output_zero`, assert
    W_0[0] == 0 (constraint-satisfaction convention, rust/src/convert.rs:838)."""
    w = circuit.evaluate(input_values)
    if check_output_zero:
        assert w[0][0] % P == 0, "constraint not satisfied: output[0] != 0"
    return prove(circuit, w, **kw)
