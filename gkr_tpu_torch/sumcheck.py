"""Linear-time GKR layer sumcheck — exact host engine (dense tables).

Proves, for one GKR layer with k = k(i+1) and v = 2k rounds,

    sum_{b,c in {0,1}^k}  add~_i(z,b,c) * (W(b) + W(c))
                        + mult~_i(z,b,c) * W(b) * W(c)

This replaces the reference's sparse-term enumeration
(`prove_sumcheck_opt`, rust/src/gkr/sumcheck.rs:35-156) with the standard
two-phase linear-time algorithm (Libra-style):

  phase 1 (rounds 1..k, variables b): precompute dense tables over b
      HA1[b] = sum_c add(z,b,c)            (per-gate scatter of eq(z,out))
      HA2[b] = sum_c add(z,b,c)  * W[c]
      HM [b] = sum_c mult(z,b,c) * W[c]
    so the summand collapses to (HA1+HM)[b]*W[b] + HA2[b].
  phase 2 (rounds k+1..2k, variables c): with b bound to b*,
      FA[c] = sum over add gates  eq(z,out)*eq(b*,left) at c=right
      FM[c] = likewise for mult gates
    summand: FA[c]*(W(b*) + W[c]) + FM[c]*W(b*)*W[c].

Each round's univariate is degree <= 2; it is evaluated at t in {0,1,2} from
the folded tables and interpolated to coefficients (highest-degree-first).
The resulting polynomials are IDENTICAL to the reference's, because both
compute the same mathematical round polynomial; the coefficient-vector
lengths are reproduced via the structural-length rules of
`get_univariate_coeff` / `mult_univariate` / `add_univariate`
(rust/src/gkr/poly.rs:388-467) — see `round_poly_len`.

Fiat–Shamir: after each round the coefficient vector is hashed with
MiMC7-91 `multi_hash(coeffs, key=0)` (rust/src/gkr/sumcheck.rs:83-85);
only the current round's coefficients are hashed, not a running transcript.
"""

from __future__ import annotations

from .field import P, eval_univariate
from .mle import MleStruct, eq_bits, eq_table, fold_msb
from .mimc import Mimc7

INV2 = pow(2, P - 2, P)


def coeffs_from_evals_deg2(y0: int, y1: int, y2: int) -> list[int]:
    """Exact deg-2 interpolation at {0,1,2} -> [c2, c1, c0]."""
    c0 = y0 % P
    c2 = (y2 - 2 * y1 + y0) * INV2 % P
    c1 = (y1 - y0 - c2) % P
    return [c2, c1, c0]


def round_poly_len(j: int, v: int, sup: list[bool], has_add: bool, has_mult: bool) -> int:
    """Structural length of the round-j (1-indexed) coefficient vector, as the
    reference's sparse algebra would produce it.

    Derivation (rust/src/gkr/sumcheck.rs + poly.rs):
      * f1 = W~(b) lives on vars 1..k, f2 = W~(c) on vars k+1..2k.
      * get_univariate_coeff length = 1 + (1 if the var appears in the sparse
        MLE with nonzero coefficient else 0); partial evaluations never drop
        terms, so per-round presence equals construction-time support.
      * add/mult wiring in binary form always contributes a length-2 factor.
      * rounds 1..v-1 include the add (resp. mult) path only when the layer
        has add (resp. mult) wires; the final round always includes both.
    """
    k = v // 2
    if j <= k:
        lf1 = 2 if sup[j - 1] else 1
        lf2 = 1
    else:
        lf1 = 1
        lf2 = 2 if sup[j - k - 1] else 1
    add_len = max(lf1, lf2) + 1
    mult_len = (lf1 + lf2 - 1) + 1
    if j == v:
        return max(add_len, mult_len)
    lens = []
    if has_add:
        lens.append(add_len)
    if has_mult:
        lens.append(mult_len)
    return max(lens) if lens else 0


def shape_coeffs(full: list[int], length: int) -> list[int]:
    """Trim [c2,c1,c0] to the structural length, asserting dropped leading
    coefficients are exactly zero."""
    assert 1 <= length <= 3
    drop = len(full) - length
    for c in full[:drop]:
        assert c % P == 0, "structural length rule violated (nonzero trimmed coeff)"
    return full[drop:]


def phase1_host_rounds(W, HA1, HA2, HM, j_start, j_end, emit, challenges):
    """Host phase-1 rounds j_start..j_end (inclusive) over int tables.
    Shared by the host engine and the device engines' small-table tails."""
    for j in range(j_start, j_end + 1):
        half = len(W) // 2
        y = []
        for t in (0, 1, 2):
            total = 0
            for s in range(half):
                wt = W[s] + t * (W[s + half] - W[s])
                at = HA1[s] + t * (HA1[s + half] - HA1[s])
                ht = HA2[s] + t * (HA2[s + half] - HA2[s])
                mt = HM[s] + t * (HM[s + half] - HM[s])
                total = (total + (at + mt) * wt + ht) % P
            y.append(total)
        emit(y[0], y[1], y[2], j)
        r = challenges[-1]
        W = fold_msb(W, r)
        HA1 = fold_msb(HA1, r)
        HA2 = fold_msb(HA2, r)
        HM = fold_msb(HM, r)
    return W, HA1, HA2, HM


def phase2_host_rounds(Wc, FA, FMwb, wb, j_start, j_end, emit, challenges):
    """Host phase-2 rounds over int tables; FMwb carries the wb factor
    (FMwb[c] = mult-scatter[c] * W~(b*)), so the summand is
    FA*(wb + W) + FMwb*W."""
    for j in range(j_start, j_end + 1):
        half = len(Wc) // 2
        y = []
        for t in (0, 1, 2):
            total = 0
            for s in range(half):
                wt = Wc[s] + t * (Wc[s + half] - Wc[s])
                fat = FA[s] + t * (FA[s + half] - FA[s])
                fmt = FMwb[s] + t * (FMwb[s + half] - FMwb[s])
                total = (total + fat * (wb + wt) + fmt * wt) % P
            y.append(total)
        emit(y[0], y[1], y[2], j)
        r = challenges[-1]
        Wc = fold_msb(Wc, r)
        FA = fold_msb(FA, r)
        FMwb = fold_msb(FMwb, r)
    return Wc, FA, FMwb


def build_phase1_tables_host(z, w_next, add_gates, mult_gates):
    n = len(w_next)
    eqz = eq_table(z)
    HA1 = [0] * n
    HA2 = [0] * n
    HM = [0] * n
    for (o, l, r) in add_gates:
        e = eqz[o]
        HA1[l] = (HA1[l] + e) % P
        HA2[l] = (HA2[l] + e * w_next[r]) % P
    for (o, l, r) in mult_gates:
        HM[l] = (HM[l] + eqz[o] * w_next[r]) % P
    return eqz, HA1, HA2, HM


def build_phase2_tables_host(eqz, b_star, w_next, add_gates, mult_gates, wb):
    n = len(w_next)
    eqb = eq_table(b_star)
    FA = [0] * n
    FMwb = [0] * n
    for (o, l, r) in add_gates:
        FA[r] = (FA[r] + eqz[o] * eqb[l]) % P
    for (o, l, r) in mult_gates:
        FMwb[r] = (FMwb[r] + eqz[o] * eqb[l] * wb) % P
    return FA, FMwb


def make_emitter(proof, challenges, v, sup, has_add, has_mult,
                 transcript: Mimc7):
    def emit(y0: int, y1: int, y2: int, j: int) -> None:
        full = coeffs_from_evals_deg2(y0, y1, y2)
        coeffs = shape_coeffs(full,
                              round_poly_len(j, v, sup, has_add, has_mult))
        proof.append(coeffs)
        challenges.append(transcript.multi_hash(coeffs, 0))
    return emit


def prove_layer_sumcheck(
    z: list[int],
    w_next: list[int],
    add_gates: list[tuple[int, int, int]],
    mult_gates: list[tuple[int, int, int]],
    k_cur: int,
    k_next: int,
    w_struct: MleStruct,
    transcript: Mimc7,
) -> tuple[list[list[int]], list[int]]:
    """Returns (round coefficient vectors, challenges r_1..r_v)."""
    k = k_next
    v = 2 * k
    assert v >= 2
    sup = w_struct.support if not w_struct.empty else [False] * k
    has_add = len(add_gates) > 0
    has_mult = len(mult_gates) > 0

    proof: list[list[int]] = []
    challenges: list[int] = []
    emit = make_emitter(proof, challenges, v, sup, has_add, has_mult,
                        transcript)

    eqz, HA1, HA2, HM = build_phase1_tables_host(z, w_next, add_gates,
                                                 mult_gates)
    W = [x % P for x in w_next]
    W, *_ = phase1_host_rounds(W, HA1, HA2, HM, 1, k, emit, challenges)

    b_star = challenges[:k]
    wb = W[0]  # W~(b*)

    FA, FMwb = build_phase2_tables_host(eqz, b_star, w_next, add_gates,
                                        mult_gates, wb)
    Wc = [x % P for x in w_next]
    phase2_host_rounds(Wc, FA, FMwb, wb, k + 1, v, emit, challenges)

    return proof, challenges


def verify_sumcheck(claim: int, proof: list[list[int]], r: list[int], v: int,
                    transcript: Mimc7) -> bool:
    """Round-consistency + Fiat–Shamir binding checks
    (python/sumcheck.py:55-70 `verify_sumcheck` semantics; returns the same
    bool, with the final claim left to the caller via `final_claim`)."""
    if len(proof) != v or len(r) != v:
        return False
    expected = claim % P
    for i in range(v):
        g = proof[i]
        if (eval_univariate(g, 0) + eval_univariate(g, 1)) % P != expected:
            return False
        if transcript.multi_hash(g, 0) != r[i]:
            return False
        expected = eval_univariate(g, r[i])
    return True


def final_claim(proof: list[list[int]], r: list[int]) -> int:
    """g_v(r_v): the value the recombination check compares against."""
    return eval_univariate(proof[-1], r[-1])
