"""Dense multilinear-extension (MLE) machinery — exact host reference.

The reference stores multivariate polynomials sparsely as term lists
(`rust/src/gkr/poly.rs`); that representation is CPU-idiomatic and
TPU-hostile.  This framework's canonical representation is the DENSE table of
values over the boolean hypercube {0,1}^k (the standard linear-time sumcheck
layout); sparse term lists (`[coeff, deg_1..deg_k]`, matching
`rust/src/gkr/poly.rs:502-536` `get_multi_ext`) are kept only at protocol
boundaries (proof fields `d` / `input_func`, circom inputs).

Conventions (identical to the reference):
  * index <-> variables: index i in [0, 2^k) has binary b_1..b_k MSB-first,
    x_1 = MSB (labels are "z||b||c" bit strings parsed big-endian,
    rust/src/convert.rs:721-728 + usize::from_str_radix(b, 2)).
  * variables are bound in order x_1, x_2, ... (rust/src/gkr/sumcheck.rs).
  * univariate coefficient vectors are highest-degree-first.

All values are Python ints in [0, P).
"""

from __future__ import annotations

from .field import P


def fold_msb(table: list[int], r: int) -> list[int]:
    """Bind x_1 (the MSB variable) to r: T'[s] = T[0s] + r*(T[1s] - T[0s]).

    Dense equivalent of `partial_eval_i(f, r, 1)` (rust/src/gkr/poly.rs:160-179)
    followed by dropping the bound variable.
    """
    half = len(table) // 2
    lo, hi = table[:half], table[half:]
    return [(a + r * (b - a)) % P for a, b in zip(lo, hi)]


def table_eval(table: list[int], point: list[int]) -> int:
    """Evaluate the MLE of `table` at `point` (len(point) folds)."""
    t = table
    for r in point:
        t = fold_msb(t, r)
    assert len(t) == 1
    return t[0]


def eq_table(point: list[int]) -> list[int]:
    """chi table: out[i] = prod_j (point_j if bit_j(i) else 1-point_j),
    i.e. the multilinear Lagrange basis evaluated at `point`
    (python/poly.py:258-262 `chi`)."""
    t = [1]
    # build from the last coordinate outward so the FIRST coordinate is the MSB
    for z in reversed(point):
        zc = (1 - z) % P
        t = [zc * b % P for b in t] + [z * b % P for b in t]
    return t


def eq_bits(point: list[int], idx: int) -> int:
    """eq(point, bits(idx)) for a single index (bits MSB-first)."""
    k = len(point)
    acc = 1
    for j, z in enumerate(point):
        bit = (idx >> (k - 1 - j)) & 1
        acc = acc * (z if bit else (1 - z) % P) % P
    return acc


def mobius(table: list[int]) -> list[int]:
    """Dense monomial-coefficient form of the MLE.

    C[m] is the coefficient of prod_{j: bit_j(m)=1} x_j (bits MSB-first, like
    table indices).  Equivalent to expanding `get_multi_ext` fully
    (rust/src/gkr/poly.rs:502-536) into a dense array.
    """
    c = list(table)
    n = len(c)
    k = n.bit_length() - 1
    # iterate axes; axis j has stride 2^(k-1-j)
    for j in range(k):
        stride = 1 << (k - 1 - j)
        block = stride << 1
        for base in range(0, n, block):
            for off in range(stride):
                lo = base + off
                hi = lo + stride
                c[hi] = (c[hi] - c[lo]) % P
    return c


class MleStruct:
    """Structural facts about a table's sparse MLE term list, needed to
    reproduce the reference's term-length-sensitive transcript shapes
    (get_univariate_coeff lengths depend on which variables appear in the
    sparse form with nonzero coefficient: rust/src/gkr/poly.rs:388-420)."""

    __slots__ = ("k", "empty", "support", "maxdeg")

    def __init__(self, k: int, empty: bool, support: list[bool], maxdeg: int):
        self.k = k
        self.empty = empty          # no nonzero terms at all (all-zero table)
        self.support = support      # support[j] (0-based j -> var x_{j+1})
        self.maxdeg = maxdeg        # max popcount of a nonzero-coeff monomial


def mle_struct(table: list[int]) -> MleStruct:
    n = len(table)
    k = n.bit_length() - 1
    c = mobius(table)
    support = [False] * k
    maxdeg = 0
    empty = True
    for m, coeff in enumerate(c):
        if coeff % P == 0:
            continue
        empty = False
        deg = bin(m).count("1")
        if deg > maxdeg:
            maxdeg = deg
        for j in range(k):
            if (m >> (k - 1 - j)) & 1:
                support[j] = True
    return MleStruct(k, empty, support, maxdeg)


def sparse_from_dense(table: list[int]) -> list[list[int]]:
    """`get_multi_ext` equivalent: list of [coeff, deg_1..deg_k] rows with
    nonzero coeff.  Term order is deterministic (ascending monomial index);
    the reference's order is HashMap-iteration-nondeterministic
    (rust/src/gkr/poly.rs:526-534), and no consumer is order-sensitive."""
    n = len(table)
    k = n.bit_length() - 1
    c = mobius(table)
    out = []
    for m, coeff in enumerate(c):
        if coeff % P == 0:
            continue
        row = [coeff] + [(m >> (k - 1 - j)) & 1 for j in range(k)]
        out.append(row)
    return out


class SparseMle:
    """Lazy sparse MLE term list: numpy-backed rows materialized on demand.

    Equals (row for row) what `sparse_from_dense` returns, but construction
    is O(1) Python given the compacted numpy arrays (monomial indices +
    canonical little-endian 16-bit coefficient limbs) — the device backend
    produces those with an on-device Möbius transform + nonzero compaction,
    so a 2^20-entry layer no longer funnels through a Python-int transform
    (VERDICT r1 weakness 4; reference equivalent: get_multi_ext at
    rust/src/convert.rs:840-847).
    """

    __slots__ = ("k", "_mon", "_limbs", "_rows")

    def __init__(self, k: int, mon_idx, coeff_limbs):
        import numpy as _np
        self.k = k
        self._mon = _np.asarray(mon_idx, dtype=_np.int64)
        self._limbs = _np.asarray(coeff_limbs, dtype=_np.uint32)
        assert self._limbs.shape == (len(self._mon), 16)
        self._rows = None

    def _materialize(self):
        if self._rows is None:
            import numpy as _np
            u16 = self._limbs.astype(_np.uint16)
            k = self.k
            bits = ((self._mon[:, None]
                     >> _np.arange(k - 1, -1, -1)[None, :]) & 1).tolist()
            self._rows = [
                [int.from_bytes(u16[i].tobytes(), "little")] + bits[i]
                for i in range(len(self._mon))]
        return self._rows

    def __len__(self):
        return len(self._mon)

    def __iter__(self):
        return iter(self._materialize())

    def __getitem__(self, i):
        return self._materialize()[i]

    def __eq__(self, other):
        if isinstance(other, SparseMle):
            other = other._materialize()
        return self._materialize() == other

    # defining __eq__ would otherwise set __hash__ = None; keep identity
    # hashing (like the plain lists-of-lists this class replaces cannot be
    # hashed at all, identity hash is strictly more permissive and is what
    # the wiring/packed caches key on)
    __hash__ = object.__hash__

    def __repr__(self):
        return f"SparseMle(k={self.k}, terms={len(self)})"


def sparse_eval(terms: list[list[int]], point: list[int]) -> int:
    """`eval_expansion` equivalent (python/poly.py:294-305): evaluate a sparse
    term list at a point."""
    res = 0
    for t in terms:
        sub = t[0] % P
        for j, d in enumerate(t[1:]):
            if d:
                sub = sub * pow(point[j], d, P) % P
        res = (res + sub) % P
    return res


def line(b: list[int], c: list[int], t: int) -> list[int]:
    """l(t) = b + (c - b) * t  (rust/src/gkr/poly.rs:538-551 `l_function`,
    python/gkr.py:88-96 `ell`)."""
    return [(bi + (ci - bi) * t) % P for bi, ci in zip(b, c)]


def restrict_to_line(w_table: list[int], b: list[int], c: list[int],
                     struct: MleStruct | None = None) -> list[int]:
    """q(t) = W~(l(t)) as highest-degree-first coefficients.

    Replaces the reference's symbolic construction
    (`reduce_multiple_polynomial`, rust/src/gkr/poly.rs:469-500) with exact
    interpolation: evaluate W~ at maxdeg+1 points of the line and interpolate.
    The output length mirrors the reference's structural rule:
    1 + max #present-vars over nonzero sparse terms; an all-zero MLE yields
    [0] (rust: res starts at vec![S::zero()] and no terms contribute).
    """
    from .field import interpolate

    if struct is None:
        struct = mle_struct(w_table)
    if struct.empty:
        return [0]
    deg = struct.maxdeg
    pts = []
    for t in range(deg + 1):
        pts.append((t, table_eval(w_table, line(b, c, t))))
    coeffs = interpolate(pts)
    assert len(coeffs) == deg + 1
    return coeffs
