"""Sparse-symbolic GKR prover — an independent re-implementation of the
reference's exact algorithm, used ONLY as a cross-validation oracle in tests.

This module deliberately follows the reference's sparse-term code paths
step-for-step (`rust/src/gkr/poly.rs`, `rust/src/gkr/sumcheck.rs:35-156`,
`rust/src/gkr/prover.rs`) so that the production dense engines
(`gkr_tpu_torch.sumcheck` / `gkr_tpu_torch.prover`, and the card engines
behind `TorchBackend`) can be asserted transcript-identical to the reference
semantics without running the reference itself.  It is O(#terms * 2^v)-ish
and only suitable for tiny circuits.  The port's copy of `gkr_tpu.spec`,
line for line, on the port's own field, MiMC, MLE, circuit and proof
modules.

Representations:
  * sparse multivariate term: [coeff, deg_1, .., deg_v]  (poly.rs term rows)
  * "binary form" wiring term: slots 1 -> factor (1-x), 2 -> factor x,
    0 -> var already bound/absent (poly.rs:26-41)
  * univariate coeff vectors highest-degree-first.
"""

from __future__ import annotations

from ..circuit import GKRCircuit
from ..field import P, add_univariate, mult_univariate
from ..mimc import Mimc7
from ..mle import sparse_from_dense
from ..proof import Proof

# ---------------------------------------------------------------- sparse ops


def partial_eval_i(f, x, i):
    """poly.rs:160-179 — bind var i (slot index i), keeping the term rows."""
    out = []
    for t in f:
        nt = list(t)
        e = t[i]
        nt[0] = t[0] * pow(x, e, P) % P
        nt[i] = 0
        out.append(nt)
    return out


def partial_eval_from(f, r, idx):
    """poly.rs:181-208 — bind vars idx..idx+len(r)-1 to r."""
    if not r:
        return [list(t) for t in f]
    out = []
    for t in f:
        nt = list(t)
        c = t[0]
        for i, x in enumerate(r):
            e = t[idx + i]
            if e == 0:
                continue
            c = c * pow(x, e, P) % P
            nt[idx + i] = 0
        nt[0] = c
        out.append(nt)
    return out


def partial_eval(f, r):
    """poly.rs:235-258 — bind vars 1..len(r), DROP bound slots."""
    if not r:
        return [list(t) for t in f]
    out = []
    for t in f:
        c = t[0]
        for i, x in enumerate(r):
            e = t[i + 1]
            if e:
                c = c * pow(x, e, P) % P
        out.append([c] + list(t[len(r) + 1:]))
    return out


def partial_eval_i_binary(f, x, i):
    """poly.rs:64-83."""
    out = []
    for t in f:
        nt = list(t)
        c = t[0]
        if t[i] == 1:
            c = c * (1 - x) % P
        elif t[i] == 2:
            c = c * x % P
        nt[0] = c
        nt[i] = 0
        out.append(nt)
    return out


def partial_eval_from_binary(f, xs, idx):
    """poly.rs:210-233."""
    out = []
    for t in f:
        nt = list(t)
        c = t[0]
        for i, x in enumerate(xs):
            s = t[idx + i]
            if s == 1:
                c = c * (1 - x) % P
                nt[idx + i] = 0
            elif s == 2:
                c = c * x % P
                nt[idx + i] = 0
        nt[0] = c
        out.append(nt)
    return out


def partial_eval_binary(f, xs):
    """poly.rs:43-62 — bind leading vars, DROP bound slots."""
    out = []
    l = len(xs)
    for t in f:
        c = t[0]
        for i in range(l):
            s = t[i + 1]
            if s == 1:
                c = c * (1 - xs[i]) % P
            elif s == 2:
                c = c * xs[i] % P
        out.append([c] + list(t[l + 1:]))
    return out


def get_univariate_coeff(f, i, is_binary):
    """poly.rs:388-420 — structural-length coefficient extraction."""
    if is_binary:
        coeffs = [0, 0]  # [deg0, deg1] before reversal
        for t in f:
            c = t[0]
            if t[i] == 1:
                coeffs[0] = (coeffs[0] + c) % P
                coeffs[1] = (coeffs[1] - c) % P
            elif t[i] == 2:
                coeffs[1] = (coeffs[1] + c) % P
        return coeffs[::-1]
    coeffs = [0]
    for t in f:
        deg = t[i]
        if len(coeffs) - 1 < deg:
            coeffs += [0] * (deg - len(coeffs) + 1)
        coeffs[deg] = (coeffs[deg] + t[0]) % P
    return coeffs[::-1]


def n_trailing_bits(wire, n):
    """sumcheck.rs:24-33 — distinct n-bit suffixes, first-occurrence order."""
    seen = set()
    out = []
    for row in wire:
        suffix = tuple(row[len(row) - n:]) if n > 0 else ()
        if suffix not in seen:
            seen.add(suffix)
            out.append(list(suffix))
    return out


# ---------------------------------------------------------- sumcheck (spec)


def prove_sumcheck_generic(g, v, transcript: Mimc7, start: int = 1):
    """Textbook O(2^v) sumcheck over an arbitrary sparse term list.

    Counterpart of the reference's generic provers — the Rust
    `prove_sumcheck` (rust/src/gkr/sumcheck.rs:158-214, dead code there)
    and the Python prototype `prove_sumcheck(g, v, start)`
    (python/sumcheck.py:6-53).  `g` is a term list [coeff, deg_1..deg_v']
    where the sumcheck variables occupy slots start..start+v-1; earlier
    slots must already be bound (degree 0).  Round polynomials are
    coefficient vectors highest-degree-first; each round's challenge is
    MiMC(multi_hash) of that round's coefficients alone (footnote 4,
    SURVEY.md section 5)."""
    proof: list[list[int]] = []
    r: list[int] = []
    g_j = [list(t) for t in g]
    for j in range(v):
        if j > 0:
            g_j = partial_eval_i(g_j, r[-1], start + j - 1)
        # sum the univariate in slot start+j over the boolean suffix cube
        acc: list[int] = []
        for a_int in range(1 << (v - j - 1)):
            a = [(a_int >> (v - j - 2 - i)) & 1 for i in range(v - j - 1)]
            f = partial_eval_from(g_j, a, start + j + 1)
            acc = add_univariate(acc, get_univariate_coeff(f, start + j,
                                                           False))
        proof.append(acc)
        r.append(transcript.multi_hash(acc, 0))
    return proof, r


def verify_sumcheck_generic(claim, proof, r, v, transcript: Mimc7):
    """python/sumcheck.py:55-70 — per-round g_j(0)+g_j(1) == expected plus
    Fiat–Shamir binding recomputation.  Same checks as
    gkr_tpu_torch.sumcheck.verify_sumcheck (re-exported here so the spec package
    is self-contained)."""
    from ..sumcheck import verify_sumcheck
    return verify_sumcheck(claim, proof, r, v, transcript)


def prove_sumcheck_opt_spec(add_wire, mult_wire, add_i, mult_i, f1, f2, v,
                            transcript: Mimc7):
    """Mirror of rust/src/gkr/sumcheck.rs:36-156."""
    proof = []
    r = []

    def path(wire, pred, f1c, f2c, j, binop):
        assignments = n_trailing_bits(wire, v - j - 1)
        acc = []
        for a in assignments:
            f1s = partial_eval_from(f1c, a, j + 2)
            f2s = partial_eval_from(f2c, a, j + 2)
            ps = partial_eval_from_binary(pred, a, j + 2)
            c1 = get_univariate_coeff(f1s, j + 1, False)
            c2 = get_univariate_coeff(f2s, j + 1, False)
            cp = get_univariate_coeff(ps, j + 1, True)
            comb = binop(c1, c2)
            acc = add_univariate(acc, mult_univariate(comb, cp))
        return acc

    # round 1 (j = 0 in the loop indexing below)
    g1 = add_univariate(
        path(add_wire, add_i, f1, f2, 0, add_univariate),
        path(mult_wire, mult_i, f1, f2, 0, mult_univariate))
    proof.append(g1)
    r.append(transcript.multi_hash(g1, 0))

    f1_j, f2_j, add_j, mult_j = f1, f2, add_i, mult_i
    for j in range(1, v - 1):
        f1_j = partial_eval_i(f1_j, r[-1], len(r))
        f2_j = partial_eval_i(f2_j, r[-1], len(r))
        add_j = partial_eval_i_binary(add_j, r[-1], len(r))
        mult_j = partial_eval_i_binary(mult_j, r[-1], len(r))
        gj = add_univariate(
            path(add_wire, add_j, f1_j, f2_j, j, add_univariate),
            path(mult_wire, mult_j, f1_j, f2_j, j, mult_univariate))
        proof.append(gj)
        r.append(transcript.multi_hash(gj, 0))

    # final round — sumcheck.rs:132-153
    f1_v = partial_eval(f1, r)
    f2_v = partial_eval(f2, r)
    add_v = partial_eval_binary(add_i, r)
    mult_v = partial_eval_binary(mult_i, r)
    c1 = get_univariate_coeff(f1_v, 1, False)
    c2 = get_univariate_coeff(f2_v, 1, False)
    ca = get_univariate_coeff(add_v, 1, True)
    cm = get_univariate_coeff(mult_v, 1, True)
    f_add = mult_univariate(add_univariate(c1, c2), ca)
    f_mult = mult_univariate(mult_univariate(c1, c2), cm)
    gv = add_univariate(f_add, f_mult)
    proof.append(gv)
    r.append(transcript.multi_hash(gv, 0))
    return proof, r


# ------------------------------------------------------------- prover (spec)


def _gate_label_row(o, l, r, kc, kn):
    bits = []
    for j in range(kc):
        bits.append((o >> (kc - 1 - j)) & 1)
    for j in range(kn):
        bits.append((l >> (kn - 1 - j)) & 1)
    for j in range(kn):
        bits.append((r >> (kn - 1 - j)) & 1)
    return bits


def _binary_form(gates, kc, kn):
    """chi_w_for_binary + add_poly merge (convert.rs:737-740)."""
    v = kc + 2 * kn
    merged: dict[tuple, int] = {}
    for (o, l, r) in gates:
        patt = tuple(b + 1 for b in _gate_label_row(o, l, r, kc, kn))
        merged[patt] = (merged.get(patt, 0) + 1) % P
    rows = [[c] + list(p) for p, c in merged.items() if c % P != 0]
    if not rows:
        rows = [[0] * (v + 1)]
    return rows


def reduce_multiple_polynomial_spec(b, c, w):
    """poly.rs:469-500."""
    res = [0]
    t = [(bi, (ci - bi) % P) for bi, ci in zip(b, c)]
    for term in w:
        poly = [term[0]]
        for i, d in enumerate(term[1:]):
            for _ in range(d):
                poly = mult_univariate(poly, [t[i][1], t[i][0]])
        res = add_univariate(res, poly)
    return res


def prove_spec(circuit: GKRCircuit, w_values, transcript: Mimc7 | None = None,
               z0=None) -> Proof:
    """Mirror of rust/src/gkr/prover.rs:6-96 over sparse forms."""
    if transcript is None:
        transcript = Mimc7()
    depth = circuit.depth()
    z = [list(z0) if z0 is not None else [0] * circuit.k(0)]
    sumcheck_proofs, sumcheck_r, q, r_stars = [], [], [], []

    for i in range(depth):
        layer = circuit.layers[i]
        kc, kn = layer.k_cur, circuit.k(i + 1)
        v = 2 * kn
        add_bin = _binary_form(layer.add_gates, kc, kn)
        mult_bin = _binary_form(layer.mult_gates, kc, kn)
        add_wire = [_gate_label_row(*g, kc, kn) for g in layer.add_gates]
        mult_wire = [_gate_label_row(*g, kc, kn) for g in layer.mult_gates]

        add_res = partial_eval_binary(add_bin, z[i]) if z[i] else add_bin
        mult_res = partial_eval_binary(mult_bin, z[i]) if z[i] else mult_bin

        w_sparse = sparse_from_dense(w_values[i + 1])
        # w_i_ext_b: extend rows to 2k+1; w_i_ext_c: shift vars by k
        f1 = [list(t) + [0] * (2 * kn + 1 - len(t)) for t in w_sparse]
        f2 = [[t[0]] + [0] * kn + list(t[1:]) for t in w_sparse]
        if not f1:
            f1 = [[0] * (2 * kn + 1)]
        if not f2:
            f2 = [[0] * (2 * kn + 1)]

        proof_i, r_i = prove_sumcheck_opt_spec(
            add_wire, mult_wire, add_res, mult_res, f1, f2, v, transcript)
        sumcheck_proofs.append(proof_i)
        sumcheck_r.append(r_i)

        b_star, c_star = r_i[:kn], r_i[kn:]
        q.append(reduce_multiple_polynomial_spec(b_star, c_star, w_sparse))
        r_star = transcript.multi_hash(proof_i[-1], 0)
        r_stars.append(r_star)
        z.append([(bi + (ci - bi) * r_star) % P
                  for bi, ci in zip(b_star, c_star)])

    return Proof(
        sumcheck_proofs=sumcheck_proofs,
        sumcheck_r=sumcheck_r,
        d=sparse_from_dense(w_values[0]),
        q=q,
        z=z,
        r=r_stars,
        depth=depth + 1,
        input_func=sparse_from_dense(w_values[depth]),
        k=circuit.k_list(),
    )
