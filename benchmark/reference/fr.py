"""BN254 Fr on torch tensors in plain PyTorch: the reference's arithmetic.

An element is a trailing axis of 9 limbs of 29 bits, least significant
first, in int64, in Montgomery form with R = 2^261.  The representation
differs from the program's on purpose (16 limbs of 16 bits, R = 2^256), so
the two share no arithmetic.  Every operation is a handful of whole-tensor
torch calls; products go through `mul` in blocks of rows so that the
temporaries fit.

Bounds: a schoolbook column sums 9 products below 2^58; REDC adds 9 more
products below 2^58 and a carry below 2^34 to a column, so every column
stays below 18 * 2^58 + 2^34 < 2^63.  Relaxed sums (`from_relaxed`) may
hold limbs up to 2^50 and values below p * R.
"""

from __future__ import annotations

import numpy as np
import torch

P = 21888242871839275222246405745257275088548364400416034343698204186575808495617
BITS = 29
NL = 9
MASK = (1 << BITS) - 1
R = 1 << (BITS * NL)
R_MOD = R % P
R2 = R * R % P
RINV = pow(R, -1, P)
NPRIME = (-pow(P, -1, 1 << BITS)) % (1 << BITS)
BLOCK = 1 << 21                  # rows a product handles at once


def int_limbs(x: int) -> list[int]:
    return [(x >> (BITS * i)) & MASK for i in range(NL)]


def limbs_from_ints(values) -> np.ndarray:
    """Python ints (reduced mod p here) -> (n, 9) int64 canonical limbs."""
    n = len(values)
    raw = b"".join((int(v) % P).to_bytes(32, "little") for v in values)
    words = np.frombuffer(raw, dtype=np.uint64).reshape(n, 4)
    out = np.empty((n, NL), dtype=np.int64)
    for i in range(NL):
        s = BITS * i
        w, o = divmod(s, 64)
        x = words[:, w] >> np.uint64(o)
        if o + BITS > 64 and w + 1 < 4:
            x = x | (words[:, w + 1] << np.uint64(64 - o))
        out[:, i] = (x & np.uint64(MASK)).astype(np.int64)
    return out


def ints_from_limbs(a: np.ndarray) -> list[int]:
    """(n, 9) canonical limbs (each below 2^29) -> Python ints."""
    a = np.asarray(a, dtype=np.int64).reshape(-1, NL).astype(np.uint64)
    words = np.zeros((a.shape[0], 5), dtype=np.uint64)
    for i in range(NL):
        s = BITS * i
        w, o = divmod(s, 64)
        words[:, w] |= a[:, i] << np.uint64(o)
        if o + BITS > 64:
            words[:, w + 1] |= a[:, i] >> np.uint64(64 - o)
    raw = words.tobytes()
    return [int.from_bytes(raw[40 * i:40 * i + 40], "little")
            for i in range(a.shape[0])]


def relaxed_int(limbs) -> int:
    """A relaxed limb vector (any int64 limbs) -> its value as a Python int."""
    return sum(int(x) << (BITS * i) for i, x in enumerate(limbs))


class Field:
    """The arithmetic on one device.  Values are (..., 9) int64 tensors in
    Montgomery form, canonical (below p) unless a name says relaxed."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.p = self._row(int_limbs(P))
        self.r2 = self._row(int_limbs(R2))
        self.one = self._row(int_limbs(R_MOD))          # 1 in Montgomery form

    def _row(self, limbs) -> torch.Tensor:
        return torch.tensor(limbs, dtype=torch.int64, device=self.device)

    # -- host <-> device ---------------------------------------------------

    def encode(self, values) -> torch.Tensor:
        """Python ints -> (n, 9) Montgomery form on the device."""
        raw = torch.from_numpy(limbs_from_ints(values)).to(self.device)
        return self.mul(raw, self.r2)

    def scalar(self, v: int) -> torch.Tensor:
        """One Python int -> (9,) Montgomery form, converted on the host."""
        return self._row(int_limbs(int(v) % P * R_MOD % P))

    def decode(self, t: torch.Tensor) -> list[int]:
        """(..., 9) Montgomery form -> canonical Python ints (row-major)."""
        flat = t.reshape(-1, NL).cpu().numpy()
        return [v * RINV % P for v in ints_from_limbs(flat)]

    @staticmethod
    def host_value(relaxed_sum) -> int:
        """A downloaded relaxed sum of Montgomery values -> the plain value."""
        return relaxed_int(relaxed_sum) * RINV % P

    # -- carries -------------------------------------------------------------

    @staticmethod
    def _carry(x: torch.Tensor) -> torch.Tensor:
        """Propagate carries (and borrows) left to right; every limb but the
        last ends in [0, 2^29).  In place on a fresh tensor.

        Three passes move every limb's carry one limb up at once, which
        leaves carries of at most one; a carry still left (a run of full
        limbs) is then rippled limb by limb."""
        lo, hi = x[..., :-1], x[..., 1:]
        for _ in range(3):
            c = lo >> BITS
            lo &= MASK
            hi += c
        if bool((lo >> BITS).any()):
            for i in range(x.shape[-1] - 1):
                x[..., i + 1] += x[..., i] >> BITS
                x[..., i] &= MASK
        return x

    def _cond_sub_p(self, x: torch.Tensor) -> torch.Tensor:
        """x in [0, 2p) with clean limbs -> x mod p."""
        s = self._carry(x - self.p)
        return torch.where((s[..., -1] < 0).unsqueeze(-1), x, s)

    # -- field operations -----------------------------------------------------

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._cond_sub_p(self._carry(a + b))

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._cond_sub_p(self._carry(a - b + self.p))

    def _redc(self, t: torch.Tensor) -> torch.Tensor:
        """(m, 2 * NL + 1) relaxed columns of value below p * R -> canonical
        value / R mod p, (m, 9).  Consumes t."""
        p = self.p
        for i in range(NL):
            m = (t[:, i] & MASK).mul_(NPRIME).bitwise_and_(MASK)
            t[:, i:i + NL].addcmul_(m.unsqueeze(1), p)
            t[:, i + 1] += t[:, i] >> BITS
        x = self._carry(t[:, NL:].clone())
        return self._cond_sub_p(x[:, :NL])

    def _mul_rows(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        t = torch.zeros(a.shape[0], 2 * NL + 1, dtype=torch.int64,
                        device=a.device)
        for i in range(NL):
            t[:, i:i + NL].addcmul_(a[:, i:i + 1], b)
        return self._redc(t)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product a * b / R mod p.  One operand may be a single
        element; otherwise both have the same number of axes, each of the
        same length or 1."""
        if a.numel() == NL:
            a, b = b, a
        if b.numel() == NL:
            shape = a.shape
            a2, b2 = a.reshape(-1, NL), b.reshape(1, NL)
        else:
            shape = tuple(max(x, y) for x, y in zip(a.shape, b.shape))
            a2 = a.expand(shape).reshape(-1, NL)
            b2 = b.expand(shape).reshape(-1, NL)
        if a2.shape[0] <= BLOCK:
            return self._mul_rows(a2, b2).reshape(shape)
        out = torch.empty_like(a2)
        for s in range(0, a2.shape[0], BLOCK):
            bs = b2 if b2.shape[0] == 1 else b2[s:s + BLOCK]
            out[s:s + BLOCK] = self._mul_rows(a2[s:s + BLOCK], bs)
        return out.reshape(shape)

    def from_relaxed(self, acc: torch.Tensor) -> torch.Tensor:
        """(m, 9) relaxed sums of Montgomery values (limbs below 2^50, value
        below p * R) -> their canonical Montgomery form."""
        t = torch.zeros(acc.shape[0], 2 * NL + 1, dtype=torch.int64,
                        device=acc.device)
        t[:, :NL] = acc
        return self.mul(self._redc(t), self.r2)

    def scatter_sum(self, index: torch.Tensor, values: torch.Tensor,
                    n: int) -> torch.Tensor:
        """out[b] = sum of values[g] over index[g] == b, for b < n."""
        acc = torch.zeros(n, NL, dtype=torch.int64, device=values.device)
        acc.index_add_(0, index, values)
        return self.from_relaxed(acc)

    def eq_table(self, point: list[int]) -> torch.Tensor:
        """chi(point)[i] = prod_j (point_j if bit j of i else 1 - point_j),
        bit 0 the most significant."""
        t = self.one.reshape(1, NL)
        for z in reversed(point):
            zs = self.scalar(z).reshape(1, NL)
            zc = self.scalar(1 - z).reshape(1, NL)
            t = torch.cat([self.mul(t, zc), self.mul(t, zs)])
        return t
