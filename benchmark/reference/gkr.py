"""The GKR prover written plainly: the reference that decides `correct`.

It proves what the protocol states (the layer sumcheck over
add~(z,b,c) (W(b) + W(c)) + mult~(z,b,c) W(b) W(c) in two phases of k
rounds, each round's degree-2 polynomial hashed with MiMC7-91 into the next
challenge; then q = W~ on the line through b* and c*, r* the hash of the
last round, z' the line at r*; the sparse monomial forms of the output and
input tables) from the circuit, the witness and the first point alone.
Tables live on one device in `fr.Field`'s arithmetic; the transcript's
coefficients, hashes and the line are Python ints.  It imports nothing of
the program.

Gates come as numpy (3, G) int64 columns [out, left, right].  Tables are
indexed with variable 1 as the most significant bit, and a round binds the
most significant remaining variable.
"""

from __future__ import annotations

import numpy as np
import torch

from .fr import NL, Field, P
from .mimc import ROUNDS, Mimc7

INV2 = pow(2, P - 2, P)


def round_len(j: int, v: int, sup: list[bool], has_add: bool,
              has_mult: bool) -> int:
    """The length of round j's coefficient list (1-based j of v = 2k): the
    term algebra's structural rule.  W(b) has degree 1 in variable j <= k
    where variable j is in its support, W(c) likewise in variable j - k;
    the wiring predicates add one degree; the last round counts both
    gate kinds, the others only the kinds the layer has."""
    k = v // 2
    db = 1 if (j <= k and sup[j - 1]) else 0
    dc = 1 if (j > k and sup[j - k - 1]) else 0
    add_len = max(db, dc) + 2
    mult_len = db + dc + 2
    if j == v:
        return max(add_len, mult_len)
    lens = ([add_len] if has_add else []) + ([mult_len] if has_mult else [])
    return max(lens, default=0)


def coefficients(y0: int, y1: int, y2: int, length: int) -> list[int]:
    """The degree-2 polynomial through (0, y0), (1, y1), (2, y2), highest
    degree first, cut to `length`; the cut coefficients must be zero."""
    c2 = (y2 - 2 * y1 + y0) * INV2 % P
    full = [c2, (y1 - y0 - c2) % P, y0 % P]
    if any(full[:3 - length]):
        raise ArithmeticError("a coefficient the structural length drops is "
                              "not zero")
    return full[3 - length:]


def evaluate(coeffs: list[int], x: int) -> int:
    acc = 0
    for c in coeffs:
        acc = (acc * x + c) % P
    return acc


def interpolate(ys: list[int]) -> list[int]:
    """The polynomial of degree < len(ys) through (t, ys[t]), t = 0, 1, ...,
    highest degree first."""
    n = len(ys)
    out = [0] * n                      # lowest degree first
    for i, y in enumerate(ys):
        num = [1]
        den = 1
        for j in range(n):
            if j == i:
                continue
            num = [(a - j * b) % P for a, b in zip([0] + num, num + [0])]
            den = den * (i - j) % P
        s = y * pow(den, P - 2, P) % P
        for d, c in enumerate(num):
            out[d] = (out[d] + c * s) % P
    return out[::-1]


def line(b: list[int], c: list[int], t: int) -> list[int]:
    return [(bi + (ci - bi) * t) % P for bi, ci in zip(b, c)]


class Reference:
    """The reference prover on `device`, hashing with MiMC7 of
    `hash_rounds` rounds (91 is the protocol's; another count is the
    control)."""

    def __init__(self, device, hash_rounds: int = ROUNDS):
        self.f = Field(device)
        self.hash = Mimc7(hash_rounds)

    def _index(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.f.device)

    # -- multilinear tables ------------------------------------------------

    def mobius(self, W: torch.Tensor) -> torch.Tensor:
        """Monomial coefficients of W's multilinear extension."""
        f = self.f
        n = W.shape[0]
        C = W
        for j in range(n.bit_length() - 1):
            C = C.reshape(1 << j, 2, n >> (j + 1), NL)
            lo, hi = C[:, 0], C[:, 1]
            C = torch.stack([lo, f.sub(hi, lo)], dim=1)
        return C.reshape(n, NL)

    def structure(self, C: torch.Tensor):
        """(empty, support, maxdeg) of a Moebius table: whether every
        coefficient is zero, which variables appear in a nonzero monomial,
        and the most variables one nonzero monomial has."""
        n = C.shape[0]
        k = n.bit_length() - 1
        idx = torch.nonzero((C != 0).any(dim=-1)).flatten()
        if idx.numel() == 0:
            return True, [False] * k, 0
        shifts = torch.arange(k - 1, -1, -1, device=idx.device)
        bits = (idx.unsqueeze(1) >> shifts) & 1
        sup = bits.any(dim=0).cpu().tolist()
        return False, [bool(x) for x in sup], int(bits.sum(dim=1).max())

    def sparse(self, W: torch.Tensor) -> list[tuple[int, int]]:
        """(monomial index, coefficient) of every nonzero monomial, in
        ascending index order."""
        C = self.mobius(W)
        idx = torch.nonzero((C != 0).any(dim=-1)).flatten()
        return list(zip(idx.tolist(), self.f.decode(C[idx])))

    def evaluate_at(self, W: torch.Tensor, points: list[list[int]]) -> list[int]:
        """W~ at each point, folding the most significant variable first."""
        f = self.f
        out = []
        for s in range(0, len(points), 8):
            group = points[s:s + 8]
            T = W.unsqueeze(0).expand(len(group), *W.shape)
            for j in range(W.shape[0].bit_length() - 1):
                h = T.shape[1] // 2
                r = torch.stack([f.scalar(p[j]) for p in group]).unsqueeze(1)
                lo, hi = T[:, :h], T[:, h:]
                T = f.add(lo, f.mul(f.sub(hi, lo), r))
            out += f.decode(T[:, 0])
        return out

    # -- the layer sumcheck --------------------------------------------------

    def _gathered(self, eqz, cols, other: torch.Tensor | None = None, key=1):
        """eq(z, out) of each gate, times other[col] where `other` is given
        (col = the gate's input that is not the key)."""
        o = self._index(cols[0])
        v = eqz.index_select(0, o)
        if other is not None:
            v = self.f.mul(v, other.index_select(0, self._index(cols[3 - key])))
        return v

    def _rounds(self, T, v: int, sup, has_add, has_mult, sums, proof, chal):
        """Bind the most significant variable of the stacked tables T
        (tables, m, 9) once a round until one entry is left, appending each
        round's polynomial and challenge to `proof` and `chal`;
        `sums(lo, hi, two)` gives the round's values at 0, 1, 2."""
        f = self.f
        while T.shape[1] > 1:
            j = len(proof) + 1
            h = T.shape[1] // 2
            lo, hi = T[:, :h], T[:, h:]
            d = f.sub(hi, lo)
            y = sums(lo, hi, f.add(hi, d))
            c = coefficients(*y, round_len(j, v, sup, has_add, has_mult))
            r = self.hash.multi_hash(c, 0)
            proof.append(c)
            chal.append(r)
            T = f.add(lo, f.mul(d, f.scalar(r)))
        return T

    def layer(self, z: list[int], W: torch.Tensor, add, mult, sup: list[bool]):
        """The layer sumcheck for point z over W (n, 9), the layer's add and
        mult gates ((3, G) columns or None) and W's support.  Returns the
        round polynomials, the challenges, the final value f(b*, c*) and
        W~(b*), W~(c*)."""
        f = self.f
        n = W.shape[0]
        k = n.bit_length() - 1
        v = 2 * k
        has_add = add is not None and add.shape[1] > 0
        has_mult = mult is not None and mult.shape[1] > 0
        eqz = f.eq_table(z)
        zero = torch.zeros(n, NL, dtype=torch.int64, device=f.device)

        # phase 1: the summand is S(b) W(b) + A2(b) with S = HA1 + HM
        keys, vals = [], []
        if has_add:
            keys.append(add[1])
            vals.append(self._gathered(eqz, add))
        if has_mult:
            keys.append(mult[1])
            vals.append(self._gathered(eqz, mult, W, key=1))
        S = f.scatter_sum(self._index(np.concatenate(keys)), torch.cat(vals), n)
        A2 = (f.scatter_sum(self._index(add[1]), self._gathered(eqz, add, W, key=1), n)
              if has_add else zero)

        def sums1(lo, hi, two):
            X = torch.stack([lo, hi, two])            # (t, table, h, 9)
            sw = f.mul(X[:, 0], X[:, 1]).sum(dim=1)
            sa = X[:, 2].sum(dim=1)
            host = torch.stack([sw, sa]).cpu().tolist()
            return [(f.host_value(host[0][t]) + f.host_value(host[1][t])) % P
                    for t in range(3)]

        proof: list[list[int]] = []
        chal: list[int] = []
        T = self._rounds(torch.stack([S, W, A2]), v, sup, has_add, has_mult,
                         sums1, proof, chal)
        wb_dev = T[1, 0]
        wb = f.decode(wb_dev)[0]
        b_star = chal[:k]

        # phase 2: the summand is G(c) W(c) + wb FA(c) with G = FA + wb FM
        eqb = f.eq_table(b_star)
        FA = (f.scatter_sum(self._index(add[2]), self._gathered(eqz, add, eqb, key=2), n)
              if has_add else zero)
        FM = (f.scatter_sum(self._index(mult[2]), self._gathered(eqz, mult, eqb, key=2), n)
              if has_mult else zero)
        G = f.add(FA, f.mul(FM, wb_dev))

        def sums2(lo, hi, two):
            X = torch.stack([lo, hi, two])
            sg = f.mul(X[:, 0], X[:, 1]).sum(dim=1)
            sa = X[:, 2].sum(dim=1)
            host = torch.stack([sg, sa]).cpu().tolist()
            return [(f.host_value(host[0][t]) + wb * f.host_value(host[1][t])) % P
                    for t in range(3)]

        T = self._rounds(torch.stack([G, W, FA]), v, sup, has_add, has_mult,
                         sums2, proof, chal)
        g, wc, fa = f.decode(T[:, 0])
        return {"proof": proof, "r": chal, "final": (g * wc + wb * fa) % P,
                "wb": wb, "wc": wc}

    # -- the whole proof -------------------------------------------------------

    def prove(self, layers, input_k: int, w_values, z0: list[int]) -> dict:
        """`layers`: (k_cur, k_next, add columns or None, mult columns or
        None) from the output layer down; `w_values`: the tables W_0 ..
        W_depth as Python ints."""
        depth = len(layers)
        ks = [layer[0] for layer in layers] + [input_k]
        z = [list(z0)]
        proofs, rs, q, r_star = [], [], [], []
        for i, (_k_cur, k_next, add, mult) in enumerate(layers):
            W = self.f.encode(w_values[i + 1])
            empty, sup, maxdeg = self.structure(self.mobius(W))
            out = self.layer(z[i], W, add, mult, [False] * k_next if empty else sup)
            b, c = out["r"][:k_next], out["r"][k_next:]
            if empty:
                q.append([0])
            else:
                q.append(interpolate(self.evaluate_at(
                    W, [line(b, c, t) for t in range(maxdeg + 1)])))
            rr = self.hash.multi_hash(out["proof"][-1], 0)
            proofs.append(out["proof"])
            rs.append(out["r"])
            r_star.append(rr)
            z.append(line(b, c, rr))
            del W
        return {"sumcheck_proofs": proofs, "sumcheck_r": rs, "q": q, "z": z,
                "r": r_star, "depth": depth + 1, "k": ks,
                "d": self.sparse(self.f.encode(w_values[0])),
                "input_func": self.sparse(self.f.encode(w_values[depth]))}
