"""GKR host verifier — full Python-prototype-strength checks.

The reference has no Rust verifier; the only complete verifier is
`python/gkr.py:202-231`, and the in-circuit verifier
(circom verifier.circom) omits the wiring recombination, the D~(z_0) binding
and the Fiat–Shamir recomputation (SURVEY §2 item 15).  This verifier
implements the full check set:

  m_0 = D~(z_0)                                        (gkr.py:205)
  per layer i:
    * every sumcheck round: g(0)+g(1) == claim, MiMC(coeffs) == r_j,
      claim <- g(r_j)                                  (sumcheck.py:55-70)
    * recombination: g_v(r_v) == add~(z_i,b*,c*)(q(0)+q(1))
                              + mult~(z_i,b*,c*) q(0)q(1)
      with add~/mult~ recomputed from the circuit wiring (gkr.py:216-222,
      strengthened: the prototype compares a prover-supplied f instead)
    * r*_i = MiMC(last round coeffs), z_{i+1} == l(b*,c*,r*_i)
    * m_{i+1} = q_i(r*_i)                              (gkr.py:226)
  final: m_d == inputFunc~(z_d)                        (gkr.py:227-229)

When `circuit` is None the recombination check is skipped (circom-parity
mode); passing the circuit enables the sound, full-strength mode.
"""

from __future__ import annotations

from .circuit import GKRCircuit
from .field import P, eval_univariate
from .mimc import Mimc7
from .mle import line, sparse_eval
from .proof import Proof
from .sumcheck import verify_sumcheck


class VerifyError(Exception):
    pass


def verify(proof: Proof, circuit: GKRCircuit | None = None,
           transcript: Mimc7 | None = None,
           raise_on_fail: bool = False) -> bool:
    if transcript is None:
        transcript = Mimc7()
    try:
        _verify(proof, circuit, transcript)
        return True
    except VerifyError:
        if raise_on_fail:
            raise
        return False


def _verify(proof: Proof, circuit: GKRCircuit | None, transcript: Mimc7) -> None:
    d_layers = proof.depth - 1  # number of sumcheck layers (== circuit depth)
    if not (len(proof.sumcheck_proofs) == len(proof.sumcheck_r)
            == len(proof.q) == len(proof.r) == d_layers):
        raise VerifyError("proof shape mismatch")
    if len(proof.z) != d_layers + 1 or len(proof.k) != d_layers + 1:
        raise VerifyError("z/k length mismatch")
    if circuit is not None:
        if circuit.depth() != d_layers or circuit.k_list() != proof.k:
            raise VerifyError("circuit/proof mismatch")

    m = sparse_eval(proof.d, proof.z[0])

    for i in range(d_layers):
        k_next = proof.k[i + 1]
        v = 2 * k_next
        proof_i = proof.sumcheck_proofs[i]
        r_i = proof.sumcheck_r[i]
        if not verify_sumcheck(m, proof_i, r_i, v, transcript):
            raise VerifyError(f"sumcheck failed at layer {i}")

        b_star = r_i[:k_next]
        c_star = r_i[k_next:]
        q_i = proof.q[i]
        q0 = eval_univariate(q_i, 0)
        q1 = eval_univariate(q_i, 1)

        if circuit is not None:
            add_e, mult_e = circuit.add_mult_eval(
                i, proof.z[i] + b_star + c_star)
            recombined = (add_e * (q0 + q1) + mult_e * q0 % P * q1) % P
            if eval_univariate(proof_i[-1], r_i[-1]) != recombined:
                raise VerifyError(f"recombination failed at layer {i}")

        r_star = transcript.multi_hash(proof_i[-1], 0)
        if r_star != proof.r[i]:
            raise VerifyError(f"r* binding failed at layer {i}")
        if proof.z[i + 1] != line(b_star, c_star, r_star):
            raise VerifyError(f"z chain broken at layer {i}")
        m = eval_univariate(q_i, r_star)

    if m != sparse_eval(proof.input_func, proof.z[d_layers]):
        raise VerifyError("final input-layer claim failed")
