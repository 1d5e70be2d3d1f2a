"""Native recursion: in-framework GKR-verifier circuit construction.

The reference's recursion detours through an external toolchain every round
(tera-templating a .circom file, shelling out to the circom compiler and a
node/wasm witness generator — aggregator.rs:316-363, file_utils.rs:76-114).
On an accelerator host that toolchain is a host-side serial bottleneck and often
simply absent.

This module removes it: circuits are described as R1CS constraints via
`ConstraintBuilder` (values computed alongside, so witness generation is
free), the GKR-verifier gadget `verify_gkr_gadget` mirrors the in-circuit
verifier (gkr_tpu_torch/circuits/gkr_verifier.circom — itself a strengthened
re-design of the reference's verifier.circom), and each aggregation round
feeds the combined constraint system straight into the standard frontend
pipeline (constraints -> trees -> layers -> GKR prove).  The final round
exports aggregated.r1cs + witness.wtns so ONLY snarkjs is needed for the
groth16 hand-off — circom and node are never invoked.

A MiMC7 gadget is included so the reference's example circuit
(rust/t.circom: out <== MiMC7(91)(in1, 0)) can be expressed natively.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

from ..field import P
from ..mimc import mimc7_constants
from ..proof import Proof
from .serialize import get_meta, modify_proof_for_circom


# ---------------------------------------------------------------------- LCs

class LC:
    """Linear combination {wire: coeff} + implicit constant via wire 0."""

    __slots__ = ("terms",)

    def __init__(self, terms: dict[int, int] | None = None):
        self.terms = dict(terms or {})

    @classmethod
    def const(cls, c: int) -> "LC":
        return cls({0: c % P} if c % P else {})

    @classmethod
    def var(cls, w: int, coeff: int = 1) -> "LC":
        return cls({w: coeff % P})

    def __add__(self, other):
        if isinstance(other, int):
            other = LC.const(other)
        t = dict(self.terms)
        for w, c in other.terms.items():
            t[w] = (t.get(w, 0) + c) % P
        return LC({w: c for w, c in t.items() if c})

    def __sub__(self, other):
        if isinstance(other, int):
            other = LC.const(other)
        return self + other.scale(P - 1)

    def scale(self, k: int) -> "LC":
        k %= P
        return LC({w: c * k % P for w, c in self.terms.items() if c * k % P})

    def is_zero(self) -> bool:
        return not self.terms

    def as_list(self) -> list[tuple[int, int]]:
        return [(c, w) for w, c in sorted(self.terms.items())]


@dataclass
class ConstraintBuilder:
    """R1CS builder with inline witness computation (wire 0 == 1)."""

    witness: list[int] = field(default_factory=lambda: [1])
    constraints: list = field(default_factory=list)
    n_public: int = 0

    def alloc(self, value: int) -> int:
        self.witness.append(value % P)
        return len(self.witness) - 1

    def value(self, lc: LC) -> int:
        return sum(c * self.witness[w] for w, c in lc.terms.items()) % P

    def mul(self, a: LC, b: LC) -> LC:
        """New wire w with constraint a * b = w."""
        w = self.alloc(self.value(a) * self.value(b))
        self.constraints.append((a.as_list(), b.as_list(),
                                 LC.var(w).as_list()))
        return LC.var(w)

    def assert_zero(self, lc: LC) -> None:
        assert self.value(lc) == 0, "unsatisfied constraint at build time"
        self.constraints.append(([], [], lc.as_list()))

    def assert_eq(self, a: LC, b: LC) -> None:
        self.assert_zero(a - b)

    def assert_mul(self, a: LC, b: LC, c: LC) -> None:
        assert self.value(a) * self.value(b) % P == self.value(c)
        self.constraints.append((a.as_list(), b.as_list(), c.as_list()))


# ------------------------------------------------------------------ gadgets

def eval_poly_gadget(b: ConstraintBuilder, coeffs: list[LC], x: LC) -> LC:
    """Horner evaluation, coeffs[0] = highest degree; len-1 constraints."""
    acc = coeffs[0]
    for c in coeffs[1:]:
        acc = b.mul(acc, x) + c
    return acc


def eval_sparse_mle_gadget(b: ConstraintBuilder, terms: list[list[LC]],
                           x: list[LC]) -> LC:
    """Sparse multilinear term-list evaluation; degrees are 0/1 wires, fully
    constrained via x^d == 1 + d*(x-1)."""
    total = LC.const(0)
    for row in terms:
        partial = row[0]
        for j, d in enumerate(row[1:]):
            factor = b.mul(d, x[j] - 1)
            partial = b.mul(partial, factor + 1)
        total = total + partial
    return total


def mimc7_gadget(b: ConstraintBuilder, x: LC, k: LC,
                 n_rounds: int = 91) -> LC:
    """circomlib-compatible MiMC7: h = t^7 chain, out = h + k."""
    cts = mimc7_constants(n_rounds)
    h = LC.const(0)
    for i in range(n_rounds):
        t = (x + k) if i == 0 else (h + k + LC.const(cts[i]))
        t2 = b.mul(t, t)
        t4 = b.mul(t2, t2)
        t6 = b.mul(t4, t2)
        h = b.mul(t6, t)
    return h + k


def mimc7_multi_gadget(b: ConstraintBuilder, xs: list[LC],
                       key: LC | None = None) -> LC:
    """Miyaguchi–Preneel multi_hash (matches Mimc7.multi_hash)."""
    r = key if key is not None else LC.const(0)
    for x in xs:
        r = r + x + mimc7_gadget(b, x, r)
    return r


def _wire_values(b: ConstraintBuilder, values: list[int]) -> list[LC]:
    return [LC.var(b.alloc(v)) for v in values]


def _eq_prod_table(b: ConstraintBuilder, coords: list[LC]) -> list[LC]:
    """Doubling-built table of all 2^k eq products over `coords` (MSB-first
    index order): 2^(k+1) - 4 multiplications total, vs k - 1 per lookup."""
    one = LC.const(1)
    if not coords:
        return [one]
    tbl = [one - coords[0], coords[0]]       # level 1: linear, no muls
    for x in coords[1:]:
        xc = one - x
        tbl = [b.mul(t, f) for t in tbl for f in (xc, x)]
    return tbl


def eval_wiring_gadget(b: ConstraintBuilder, gates, k_cur: int, k_next: int,
                       point: list[LC]) -> LC:
    """In-circuit wiring-MLE evaluation: sum over gates of
    eq(bits(out)||bits(l)||bits(r), point).  Gate labels are compile-time
    constants, so each eq factor is linear (x_j or 1-x_j).

    Cost control (this check dominates recursive-round growth): when the
    gate list is dense enough, build the three coordinate eq-product tables
    by doubling (~2*(2^k_cur + 2*2^k_next) muls total) and spend only 2
    muls per gate; otherwise walk per-gate products with a shared-prefix
    memo (sorted gates reuse common label prefixes).  Both are exact.

    This is the recombination ingredient the reference's circom verifier
    omits entirely (verifier.circom:22-29, SURVEY §2 item 15)."""
    nbits = k_cur + 2 * k_next
    assert len(point) == nbits
    if not gates:
        return LC.const(0)
    one = LC.const(1)
    naive_cost = len(gates) * max(nbits - 1, 0)
    table_cost = ((1 << (k_cur + 1)) + 2 * (1 << (k_next + 1))
                  + 2 * len(gates))
    total = LC.const(0)
    if table_cost < naive_cost:
        t_out = _eq_prod_table(b, point[:k_cur])
        t_b = _eq_prod_table(b, point[k_cur:k_cur + k_next])
        t_c = _eq_prod_table(b, point[k_cur + k_next:])
        for (o, l, r) in gates:
            total = total + b.mul(b.mul(t_out[o], t_b[l]), t_c[r])
        return total
    memo: dict[tuple, LC] = {}
    for (o, l, r) in sorted(gates):
        label = o << (2 * k_next) | l << k_next | r
        bits = tuple((label >> (nbits - 1 - j)) & 1 for j in range(nbits))
        acc = None
        start = 0
        for j in range(nbits, 0, -1):          # longest memoized prefix
            hit = memo.get(bits[:j])
            if hit is not None:
                acc, start = hit, j
                break
        for j in range(start, nbits):
            factor = point[j] if bits[j] else (one - point[j])
            acc = factor if acc is None else b.mul(acc, factor)
            memo[bits[:j + 1]] = acc
        total = total + acc
    return total


class ProofShape(NamedTuple):
    """Structural (unpadded) coefficient lengths of a proof — compile-time
    constants of the circuit being verified (round_poly_len / q degree), NOT
    witness data.  They let the gadget hash exactly the structural-length
    suffix of a circom-padded proof, resolving the round-2 padding/full_fs
    conflict: padding is LEADING zeros, so the true coefficients are the
    last `len` wires, and the gadget pins every padding wire to zero."""
    round_lens: list[list[int]]      # per layer, per round
    q_lens: list[int]                # per layer


def proof_shape(proof: Proof) -> ProofShape:
    """Extract the structural shape from an UNPADDED proof."""
    return ProofShape(
        [[len(rnd) for rnd in layer] for layer in proof.sumcheck_proofs],
        [len(qq) for qq in proof.q])


def verify_gkr_gadget(b: ConstraintBuilder, proof: Proof,
                      meta: list[int] | None = None, circuit=None,
                      full_fs: bool | None = None,
                      shape: ProofShape | None = None) -> dict:
    """In-circuit GKR verifier at FULL host-verifier strength
    (verifier.py), closing the soundness gaps the reference's
    verifier.circom leaves open (free `sumcheckr`/`r` inputs, no wiring
    recombination — rust verifier.circom:22-29):

      * Dtilde(z_0) initial-claim binding, z_0 bound to the 0-vector
        convention (rust/src/gkr/prover.rs:17-21);
      * per round: g_j(0)+g_j(1) == claim AND (full_fs) the Fiat–Shamir
        challenge is RECOMPUTED in-circuit, r_ij == MiMC7.multi_hash(g_j);
      * per layer: r*_i == r_{i,v} (the line challenge IS the last round's
        hash — same coefficients, key 0, so one equality constraint), and
        the z-chain z_{i+1} == b* + (c* - b*) * r*_i is enforced;
      * (with `circuit`) the wiring recombination
        g_v(r_v) == add~(z_i,b*,c*)(q(0)+q(1)) + mult~(z_i,b*,c*) q(0)q(1);
      * final inputFunc~(z_{d-1}) equality.

    Costs (constraints): full_fs adds ~364*len(coeffs) per round (91 MiMC7
    rounds x 4 muls per hashed coefficient); the recombination adds
    (k_i + 2k_{i+1} - 1) muls per gate of layer i.  For the toy depth-3
    circuit the full gadget is ~7k constraints vs ~60 for the weak
    (reference-parity) version.

    The transcript hashes STRUCTURAL-length coefficient lists while the
    circom proof shape front-pads them with zeros (serialize.py /
    aggregator.rs:143-213).  With a `shape` (the structural lengths — circuit
    compile-time constants), the gadget reconciles the two: every padding
    wire is constrained to zero and the MiMC hash consumes only the
    structural suffix, so the SAME mode is circom-shape-compatible AND
    transcript-sound.  full_fs defaults on; for a padded proof it requires
    `shape` (pass full_fs=False explicitly for the weak reference-parity
    gadget, verifier.circom:22-29)."""
    padded = meta is not None
    if full_fs is None:
        full_fs = (not padded) or (shape is not None)
    if meta is None:
        meta = get_meta([proof])[0]
    if shape is None:
        if padded and full_fs:
            raise ValueError(
                "full_fs over a circom-padded proof needs the structural "
                "ProofShape (pass shape=proof_shape(unpadded_proof))")
        shape = proof_shape(proof)   # unpadded: pad widths are all zero
    d = meta[0]

    wires = {
        "sumcheckProof": [[_wire_values(b, rnd) for rnd in layer]
                          for layer in proof.sumcheck_proofs],
        "sumcheckr": [_wire_values(b, layer) for layer in proof.sumcheck_r],
        "q": [_wire_values(b, qq) for qq in proof.q],
        "D": [_wire_values(b, t) for t in proof.d],
        "z": [_wire_values(b, zz) for zz in proof.z],
        "r": _wire_values(b, proof.r),
        "inputFunc": [_wire_values(b, t) for t in proof.input_func],
    }

    if full_fs:
        # z_0 is the protocol constant 0-vector; bind the witness wires.
        for zw, zv in zip(wires["z"][0], proof.z[0]):
            b.assert_eq(zw, LC.const(zv))

    # initial claim: Dtilde(z_0)
    claim = eval_sparse_mle_gadget(b, wires["D"], wires["z"][0][:meta[2]])

    for i in range(d - 1):
        k_next = meta[9 + i]
        v = 2 * k_next
        rounds = wires["sumcheckProof"][i][:v]
        rs = wires["sumcheckr"][i]
        expected = claim
        for j in range(v):
            coeffs = rounds[j]
            if full_fs:
                # pin padding wires to zero: a forgery cannot smuggle extra
                # high-degree coefficients into the padded prefix
                pad = len(coeffs) - shape.round_lens[i][j]
                for w in coeffs[:pad]:
                    b.assert_eq(w, LC.const(0))
            at0 = coeffs[-1]
            at1 = coeffs[0]
            for c in coeffs[1:]:
                at1 = at1 + c
            b.assert_eq(at0 + at1, expected)
            if full_fs:
                # challenges are not free inputs: recompute MiMC7 in-circuit
                # over exactly the structural-length coefficient suffix (the
                # transcript's hash input — fused.py shape_coeffs rules)
                b.assert_eq(rs[j], mimc7_multi_gadget(b, coeffs[pad:]))
            if j != v - 1:
                expected = eval_poly_gadget(b, coeffs, rs[j])
        g_final = eval_poly_gadget(b, rounds[v - 1], rs[v - 1])

        if full_fs:
            # q's padded prefix must be zero too (it feeds q(0)/q(1)/q(r*))
            qpad = len(wires["q"][i]) - shape.q_lens[i]
            for w in wires["q"][i][:qpad]:
                b.assert_eq(w, LC.const(0))
            # r*_i = multi_hash(last round coeffs) = r_{i,v} — one equality.
            b.assert_eq(wires["r"][i], rs[v - 1])
            # z-chain: z_{i+1} = b* + (c* - b*) * r*_i
            b_star, c_star = rs[:k_next], rs[k_next:v]
            for t in range(k_next):
                diff = b.mul(c_star[t] - b_star[t], wires["r"][i])
                b.assert_eq(wires["z"][i + 1][t], b_star[t] + diff)

        if circuit is not None:
            # wiring recombination (full verifier strength)
            layer = circuit.layers[i]
            point = (wires["z"][i][:layer.k_cur]
                     + rs[:k_next] + rs[k_next:v])
            add_e = eval_wiring_gadget(b, layer.add_gates, layer.k_cur,
                                       k_next, point)
            mult_e = eval_wiring_gadget(b, layer.mult_gates, layer.k_cur,
                                        k_next, point)
            q0 = wires["q"][i][-1]
            q1 = wires["q"][i][0]
            for c in wires["q"][i][1:]:
                q1 = q1 + c
            lhs = b.mul(add_e, q0 + q1) + b.mul(mult_e, b.mul(q0, q1))
            b.assert_eq(g_final, lhs)

        # claim for the next layer: q_i(r*_i)
        claim = eval_poly_gadget(b, wires["q"][i], wires["r"][i])

    final = eval_sparse_mle_gadget(b, wires["inputFunc"],
                                   wires["z"][d - 1][:meta[7]])
    b.assert_eq(claim, final)
    return wires


# ------------------------------------------------------- native aggregation

def builder_to_r1cs(b: ConstraintBuilder):
    """In-memory R1csFile/WtnsFile objects for the frontend pipeline."""
    from ..frontend.r1cs import R1csFile, R1csHeader
    from ..frontend.wtns import WtnsFile
    header = R1csHeader(
        field_size=32, prime=P, n_wires=len(b.witness),
        n_pub_out=b.n_public, n_pub_in=0,
        n_prv_in=len(b.witness) - 1 - b.n_public,
        n_labels=len(b.witness), n_constraints=len(b.constraints))
    return (R1csFile(header, list(b.constraints)),
            WtnsFile(P, list(b.witness)))


def prove_round_native(user_fn, user_input: dict,
                       previous_proofs=None,
                       backend=None, full_fs: bool = True,
                       check_verify: bool = True,
                       recombination: bool = True,
                       width_limit: int = 1):
    """One aggregation round: user constraints + verifier gadgets for every
    previous proof, then GKR-prove the combined system (subcircuits proved
    in parallel, the rayon par_iter analog — aggregator.rs:350-355).

    `previous_proofs` items may be bare Proofs or (Proof, GKRCircuit) pairs;
    pairs enable the wiring-recombination check when `recombination` is on
    (the default — bare Proofs silently skip it).  The embedded gadget
    always uses the circom-padded proof shape (interoperable with
    aggregated.json); `full_fs` (default ON) additionally recomputes every
    Fiat–Shamir challenge in-circuit over the structural-length coefficient
    suffix with the padding pinned to zero — the full-strength,
    transcript-sound mode (cost: ~364 constraints per hashed coefficient).
    full_fs=False selects the reference-parity weak gadget
    (verifier.circom:22-29 free challenge inputs).

    `width_limit` defaults to 1 (single subcircuit per round) rather than
    the reference's 20: each subcircuit proof costs the NEXT round a full
    verifier gadget scaling with its proof depth, so splitting multiplies
    the recursion's growth rate by ~#subcircuits.  Pass 20 for
    reference-parity round shapes (and intra-round task parallelism)."""
    from .aggregator import prove_subcircuits

    b = build_round_native(user_fn, user_input, previous_proofs,
                           full_fs=full_fs, recombination=recombination)
    circuits, w_values_list = compile_round_native(b, width_limit)
    proofs = prove_subcircuits(circuits, w_values_list, backend=backend,
                               check_verify=check_verify)
    return list(zip(proofs, circuits)), b


def build_round_native(user_fn, user_input: dict, previous_proofs=None,
                       full_fs: bool = True, recombination: bool = True):
    """A round's constraint system: the user circuit and one verifier
    gadget per previous proof (`prove_round_native`'s first stage)."""
    b = ConstraintBuilder()
    user_fn(b, user_input)
    if previous_proofs:
        items = [(p, None) if isinstance(p, Proof) else p
                 for p in previous_proofs]
        proofs_only = [p for p, _ in items]
        metas = get_meta(proofs_only)
        padded = modify_proof_for_circom(proofs_only, metas)
        for (proof, circ), pp, meta in zip(items, padded, metas):
            verify_gkr_gadget(b, pp, meta,
                              circuit=circ if recombination else None,
                              full_fs=full_fs,
                              shape=proof_shape(proof) if full_fs else None)
    return b


def compile_round_native(b: ConstraintBuilder, width_limit: int = 1):
    """A built round's GKR subcircuits and their w_values
    (`prove_round_native`'s second stage)."""
    from ..frontend.compiler import compile_r1cs_to_gkr
    r1cs, wtns = builder_to_r1cs(b)
    circuits, w_values_list, _ = compile_r1cs_to_gkr(
        r1cs, wtns, check=True, width_limit=width_limit)
    return circuits, w_values_list


def export_native(path: str, b: ConstraintBuilder):
    """<path>.r1cs / <path>.wtns of a built round, the snarkjs groth16
    hand-off."""
    from ..frontend.r1cs import R1csFile
    from ..frontend.wtns import WtnsFile
    R1csFile.write(f"{path}.r1cs", P, n_wires=len(b.witness),
                   n_pub_out=b.n_public, n_pub_in=0,
                   n_prv_in=len(b.witness) - 1, constraints=b.constraints)
    WtnsFile.write(f"{path}.wtns", P, b.witness)


def prove_all_native(user_fn, inputs: list[dict], backend=None,
                     export_final: str | None = None,
                     full_fs: bool = True, check_verify: bool = True,
                     recombination: bool = True,
                     width_limit: int = 1):
    """Full aggregation: round 0 direct, middle rounds with verifier
    gadgets, final round exported as aggregated.r1cs/witness.wtns for the
    snarkjs groth16 hand-off (no circom/node anywhere).  Each round
    self-verifies by default (check_verify), unlike the reference."""
    pairs = None
    final_builder = None
    for i, user_input in enumerate(inputs):
        prev = pairs if i > 0 else None
        pairs, final_builder = prove_round_native(
            user_fn, user_input, prev, backend=backend, full_fs=full_fs,
            check_verify=check_verify, recombination=recombination,
            width_limit=width_limit)
    if export_final and final_builder is not None:
        export_native(export_final, final_builder)
    return [p for p, _ in pairs]
