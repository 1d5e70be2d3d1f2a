"""Word-level models of the two Montgomery products built for Hopper's
pipes (gkr_tpu_torch/csrc/fr.cuh `fr_mul_f64` and `fr_mul_cc`), in pure
Python.

`f64` multiplies on the FP64 pipe: 5 limbs of 52 bits held as exact
doubles, each limb product split exactly into a high and a low part by two
FMAs against the offset 2^104 (the high one rounded toward zero), the
parts' bit patterns summed as 64-bit integers into 10 columns whose start
values cancel the patterns' exponent bits, and a Montgomery reduction of
52 + 52 + 52 + 52 + 48 bits (R = 2^256), each factor m taken with integer
instructions.  The model keeps the source's limbs, its product-scanning
order of columns, every FMA and subtraction and every column's 64-bit
register, and asserts each bound the source states: every FMA's rounded
result is the split the source claims and has at most 53 significant bits,
every column (register and true value) stays below 2^64, every cleared
column is divisible by its radix, and the last step's m has 48 bits.

`cc` is CIOS on 8 words of 32 bits with the carries in the multiply-adds
(PTX `mad.lo.cc` / `madc.hi.cc` chains, even and odd column accumulators,
as in Supranational's sppark `mont_t`).  The model runs each PTX chain
with an explicit carry flag and asserts that no carry the source drops is
ever set and that no add without a carry out overflows.

Both are held to host ints (a b 2^-256 mod p), to the port's plain
`kernels.mont_mul_plain` and to the JAX package's `jaxeng.limbs.mont_mul`,
on edge values (a up to 3p - 1, fr_mul's contract) and seeded random pairs;
every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gkr_tpu.field import P, R
from gkr_tpu.jaxeng import limbs as JL

from gkr_tpu_torch.torcheng import kernels as K

M32 = (1 << 32) - 1
M64 = 1 << 64
R_INV = pow(R, P - 2, P)


def words(v: int) -> list[int]:
    """fr.cuh's Fr: 8 words of 32 bits, least significant first."""
    assert 0 <= v < 1 << 256
    return [(v >> (32 * k)) & M32 for k in range(8)]


def value(ws: list[int]) -> int:
    return sum(w << (32 * k) for k, w in enumerate(ws))


def reduce_once(ws: list[int]) -> int:
    """fr.cuh `fr_reduce_once`: t < 2p -> t mod p."""
    t = value(ws)
    assert t < 2 * P
    return t - P if t >= P else t


# ---------------------------------------------------------------------- f64

B52 = 52
M52 = (1 << B52) - 1
LIMBS = 5
COLS = 2 * LIMBS
C_HI = 1 << 104                      # the high FMA's offset: its binade [2^104, 2^105)
C_SUB = (1 << 104) + (1 << 52)       # the low FMA's addend is C_SUB - hi
LO_BITS = 0x4330000000000000         # bit pattern of 2^52
HI_BITS = 0x4670000000000000         # bit pattern of 2^104
NP52 = 0x1F593EFFFFFFF               # fr.cuh F52_NP: -p^-1 mod 2^52
P52 = [(P >> (B52 * j)) & M52 for j in range(LIMBS)]


def significant_bits(v: int) -> int:
    """Bits from the top set bit to the lowest set bit of |v|."""
    v = abs(v)
    return 0 if v == 0 else v.bit_length() - ((v & -v).bit_length() - 1)


def is_double(v: int) -> bool:
    return significant_bits(v) <= 53


def pairs(s: int) -> int:
    """fr.cuh `f52_pairs`: limb pairs (i, j), 0 <= i, j < 5, with i + j = s."""
    return 0 if s < 0 or s > 2 * (LIMBS - 1) else min(s, 2 * (LIMBS - 1) - s) + 1


def col_init(c: int) -> int:
    """fr.cuh `f52_col_init`: minus the exponent bits of every pattern a
    column takes (the product's and the reduction's), mod 2^64."""
    return (-(2 * pairs(c) * LO_BITS + 2 * pairs(c - 1) * HI_BITS)) % M64


class Columns:
    """The 10 64-bit column registers, beside the true sums they stand for
    (each register's patterns minus their exponent bits)."""

    def __init__(self):
        self.reg = [col_init(c) for c in range(COLS)]
        self.true = [0] * COLS

    def add(self, c: int, bits: int, v: int) -> None:
        self.reg[c] = (self.reg[c] + bits) % M64
        self.true[c] += v
        assert self.true[c] < M64

    def low(self, c: int, bits: int) -> int:
        """The low bits of column c as the register holds them: the
        exponent bits are multiples of 2^52, so the low 52 are exact."""
        assert bits <= B52
        assert self.reg[c] % (1 << bits) == self.true[c] % (1 << bits)
        return self.reg[c] % (1 << bits)

    def full(self, c: int) -> int:
        """Column c once every pattern it takes is in: the start value has
        cancelled their exponent bits."""
        assert self.reg[c] == self.true[c]
        return self.reg[c]


def mac(cols: Columns, c: int, x: int, y: int) -> None:
    """fr.cuh `f52_mac`: x y (x, y < 2^52, exact doubles) into columns c
    (low part) and c + 1 (high part)."""
    assert 0 <= x <= M52 and 0 <= y <= M52 and is_double(x) and is_double(y)
    xy = x * y
    # hi = __fma_rz(x, y, 2^104): x y < 2^104 keeps the exact sum in the
    # binade [2^104, 2^105), where a double's ulp is 2^52; rounding toward
    # zero drops the low 52 bits
    assert C_HI <= xy + C_HI < 2 * C_HI
    H = xy >> B52
    hi = C_HI + (H << B52)
    assert is_double(hi)
    # sub = C_SUB - hi = (1 - H) 2^52: an exact difference, 53 bits
    sub = C_SUB - hi
    assert is_double(sub)
    # lo = __fma_rn(x, y, sub) = L + 2^52, L = x y - H 2^52 in [0, 2^52):
    # the exact result lies in [2^52, 2^53), a double with ulp 1
    lo = xy + sub
    assert (1 << 52) <= lo < (1 << 53) and is_double(lo)
    L = lo - (1 << 52)
    cols.add(c, LO_BITS + L, L)
    cols.add(c + 1, HI_BITS + H, H)


def limb_double(lo32: int, hi20: int) -> int:
    """fr.cuh `f52_double`: the double of bits (hi20 | 0x43300000, lo32),
    2^52 + limb, minus 2^52: the limb, exactly."""
    assert lo32 <= M32 and hi20 < 1 << 20
    v = (1 << 52) + (hi20 << 32 | lo32) - (1 << 52)
    assert is_double(v)
    return v


def fr52(ws: list[int]) -> list[int]:
    """fr.cuh `fr52_from_fr`: 8 words (value < 2^256) -> 5 limbs of 52 bits."""
    w = ws + [0]

    def funnel(lo, hi, s):                      # __funnelshift_r
        return ((hi << 32 | lo) >> s) & M32

    return [limb_double(w[0], w[1] & 0xFFFFF),
            limb_double(funnel(w[1], w[2], 20), funnel(w[2], w[3], 20) & 0xFFFFF),
            limb_double(funnel(w[3], w[4], 8), funnel(w[4], w[5], 8) & 0xFFFFF),
            limb_double(funnel(w[4], w[5], 28), funnel(w[5], w[6], 28) & 0xFFFFF),
            limb_double(funnel(w[6], w[7], 16), w[7] >> 16)]


def fr_mul_f64(a: int, b: int, trace: list | None = None) -> int:
    """fr.cuh `fr_mul_f64(a, fr52_from_fr(b))`: a below 3p, b below p ->
    a b 2^-256 mod p, canonical.  `trace` collects each step's radix and m."""
    x, y = fr52(words(a)), fr52(words(b))
    assert x[LIMBS - 1] < 1 << 48 and y[LIMBS - 1] < 1 << 48
    cols = Columns()
    m = []
    for c in range(COLS):
        # column c's limb products, then the reduction's m_k p_{c-k} for the
        # factors already taken
        for i in range(max(0, c - LIMBS + 1), min(c, LIMBS - 1) + 1):
            mac(cols, c, x[i], y[c - i])
        for k in range(max(0, c - LIMBS + 1), min(c, LIMBS)):
            mac(cols, c, m[k], P52[c - k])
        if c < LIMBS:
            # step c clears 52 bits (48 at the last: 4 x 52 + 48 = 256)
            bits = B52 if c < LIMBS - 1 else 48
            mc = (cols.low(c, bits) * NP52) % (1 << bits)
            if trace is not None:
                trace.append((bits, mc))
            m.append(limb_double(mc & M32, mc >> 32))
            mac(cols, c, m[c], P52[0])
            assert cols.true[c] % (1 << bits) == 0
        if c < COLS - 1:
            cols.add(c + 1, cols.full(c) >> B52, cols.full(c) >> B52)
    # T / 2^256 = (col4 >> 48) + 16 (c5 + 2^52 c6 + ... + 2^208 c9), with
    # each column reduced to 52 bits by the carries above
    low4 = (cols.full(4) >> 48) & 15
    c = [cols.full(k) & M52 for k in range(5, 9)] + [cols.full(9)]
    assert c[4] < 1 << 44
    v = low4 | c[0] << 4 | c[1] << 56 | c[2] << 108 | c[3] << 160 | c[4] << 212
    ws = [(low4 | c[0] << 4) & M32,
          (c[0] >> 28 | c[1] << 24) & M32,
          (c[1] >> 8) & M32,
          (c[1] >> 40 | c[2] << 12) & M32,
          (c[2] >> 20) & M32,
          c[3] & M32,
          (c[3] >> 32 | c[4] << 20) & M32,
          (c[4] >> 12) & M32]
    assert value(ws) == v
    return reduce_once(ws)


# ----------------------------------------------------------------------- cc

NP32 = 0xEFFFFFFF                    # fr.cuh FR_NPRIME32: -p^-1 mod 2^32
PW = words(P)


class Ptx:
    """The PTX integer ops of fr_mul_cc on one thread's carry flag."""

    def __init__(self):
        self.cf = 0

    def _out(self, r: int, cc: bool) -> int:
        if cc:
            self.cf = r >> 32
        else:
            assert r <= M32, "an add without a carry out overflowed"
        return r & M32

    def mad_lo(self, a, b, c, carry_in=False, cc=True):
        return self._out(((a * b) & M32) + c + (self.cf if carry_in else 0), cc)

    def mad_hi(self, a, b, c, carry_in=False, cc=True):
        return self._out(((a * b) >> 32) + c + (self.cf if carry_in else 0), cc)

    def add(self, a, b, carry_in=False, cc=True):
        return self._out(a + b + (self.cf if carry_in else 0), cc)


def cc_step(t: Ptx, ev, od, a, bi, first: bool) -> None:
    """fr.cuh `cc_step`: one CIOS word.  ev holds columns k at word k, od
    columns k + 1 at word k; after the step the two swap roles (the shift
    by one word)."""
    if first:
        for j in range(0, 8, 2):                 # cc_mul_n: no carries
            od[j], od[j + 1] = (a[j + 1] * bi) & M32, (a[j + 1] * bi) >> 32
            ev[j], ev[j + 1] = (a[j] * bi) & M32, (a[j] * bi) >> 32
    else:
        # chain 1: ev[0] += od[1]; od = od >> 2 words + a_odd bi
        ev[0] = t.add(ev[0], od[1])
        for j in range(0, 6, 2):
            od[j] = t.mad_lo(a[j + 1], bi, od[j + 2], carry_in=True)
            od[j + 1] = t.mad_hi(a[j + 1], bi, od[j + 3], carry_in=True)
        od[6] = t.mad_lo(a[7], bi, 0, carry_in=True)
        od[7] = t.mad_hi(a[7], bi, 0, carry_in=True, cc=False)
        # chain 2: ev += a_even bi, its carry into od[7]
        for j in range(0, 8, 2):
            ev[j] = t.mad_lo(a[j], bi, ev[j], carry_in=j > 0)
            ev[j + 1] = t.mad_hi(a[j], bi, ev[j + 1], carry_in=True)
        od[7] = t.add(od[7], 0, carry_in=True, cc=False)
    mi = (ev[0] * NP32) & M32
    # chain 3: od += p_odd mi; its carry out is dropped (never set)
    for j in range(0, 8, 2):
        od[j] = t.mad_lo(PW[j + 1], mi, od[j], carry_in=j > 0)
        od[j + 1] = t.mad_hi(PW[j + 1], mi, od[j + 1], carry_in=True, cc=j < 6)
    # chain 4: ev += p_even mi, its carry into od[7]; ev[0] is cleared
    for j in range(0, 8, 2):
        ev[j] = t.mad_lo(PW[j], mi, ev[j], carry_in=j > 0)
        ev[j + 1] = t.mad_hi(PW[j], mi, ev[j + 1], carry_in=True)
    od[7] = t.add(od[7], 0, carry_in=True, cc=False)
    assert ev[0] == 0


def fr_mul_cc(a: int, b: int) -> int:
    """fr.cuh `fr_mul_cc`: a below 3p, b below p -> a b 2^-256 mod p."""
    aw, bw = words(a), words(b)
    t = Ptx()
    ev, od = [0] * 8, [0] * 8
    for i in range(0, 8, 2):
        cc_step(t, ev, od, aw, bw[i], i == 0)
        cc_step(t, od, ev, aw, bw[i + 1], False)
    # merge: ev (column k at word k) += od (column k at word k + 1)
    ev[0] = t.add(ev[0], od[1])
    for j in range(1, 7):
        ev[j] = t.add(ev[j], od[j + 1], carry_in=True)
    ev[7] = t.add(ev[7], 0, carry_in=True, cc=False)
    return reduce_once(ev)


# -------------------------------------------------------------------- tests

PRODUCTS = {"f64": fr_mul_f64, "cc": fr_mul_cc}


def edge_a() -> list[int]:
    """fr_mul's a: any value below 3p."""
    return [0, 1, P - 1, R % P, 2 * P - 1, 3 * P - 1, P, 2 * P,
            (1 << 255) - 1, 3 * P - (1 << 208)]


def edge_b() -> list[int]:
    return [0, 1, P - 1, P - 2, R % P, (1 << 253) - 1, (1 << 208) - 1,
            P - (1 << 52)]


def rand_below(rng, n: int, bound: int) -> list[int]:
    raw = rng.bytes(40 * n)
    return [int.from_bytes(raw[40 * i:40 * i + 40], "little") % bound
            for i in range(n)]


def limbs16(vs: list[int]) -> np.ndarray:
    """Raw 16-bit limbs of values below 2^256 (not reduced mod p)."""
    return np.array([[(v >> (16 * i)) & 0xFFFF for i in range(16)] for v in vs],
                    dtype=np.int64)


def mont(a: int, b: int) -> int:
    return a * b * R_INV % P


def held_to_references(name: str, xs: list[int], ys: list[int]) -> None:
    """The model against host ints, kernels.mont_mul_plain and the JAX
    mont_mul, exactly."""
    got = [PRODUCTS[name](x, y) for x, y in zip(xs, ys)]
    assert got == [mont(x, y) for x, y in zip(xs, ys)]
    a, b = limbs16(xs), limbs16(ys)
    plain = K.mont_mul_plain(torch.from_numpy(a).to(torch.int32),
                             torch.from_numpy(b).to(torch.int32))
    assert limbs16(got).tolist() == plain.to(torch.int64).tolist()
    jx = np.asarray(JL.mont_mul(jnp.asarray(a, dtype=jnp.uint32),
                                jnp.asarray(b, dtype=jnp.uint32)))
    assert limbs16(got).tolist() == jx.astype(np.int64).tolist()


@pytest.mark.parametrize("name", sorted(PRODUCTS))
def test_product_model_on_edge_values(name):
    xs = [x for x in edge_a() for _ in edge_b()]
    ys = [y for _ in edge_a() for y in edge_b()]
    held_to_references(name, xs, ys)


@pytest.mark.parametrize("name", sorted(PRODUCTS))
def test_product_model_on_random_pairs(name):
    rng = np.random.default_rng(90 if name == "f64" else 91)
    xs = rand_below(rng, 600, 3 * P) + rand_below(rng, 600, P)
    ys = rand_below(rng, 1200, P)
    held_to_references(name, xs, ys)


@pytest.mark.parametrize("name", sorted(PRODUCTS))
def test_product_model_chain_matches_mont_chain_plain(name):
    """x <- x b / R nine times, as k_mont_chain runs it, against the probe's
    plain version."""
    rng = np.random.default_rng(92)
    xs, ys = rand_below(rng, 16, P) + edge_b(), rand_below(rng, 16, P) + edge_b()[::-1]
    got = []
    for x, y in zip(xs, ys):
        for _ in range(K.MONT_DEPTHS[1]):
            x = PRODUCTS[name](x, y)
        got.append(x)
    a = torch.from_numpy(limbs16(xs)).to(torch.int32)
    b = torch.from_numpy(limbs16(ys)).to(torch.int32)
    want = K.mont_chain_plain(a, b, K.MONT_DEPTHS[1])
    assert limbs16(got).tolist() == want.to(torch.int64).tolist()


def test_f64_reduction_clears_four_52_bit_radices_and_one_of_48():
    """R stays 2^256: the steps' m take 52, 52, 52, 52 and 48 bits."""
    rng = np.random.default_rng(93)
    for x, y in zip(rand_below(rng, 50, 3 * P), rand_below(rng, 50, P)):
        trace = []
        fr_mul_f64(x, y, trace)
        assert [bits for bits, _ in trace] == [52, 52, 52, 52, 48]
        assert all(mc < 1 << bits for bits, mc in trace)
    assert sum(bits for bits, _ in trace) == 256
    assert NP52 == (-pow(P, -1, 1 << 52)) % (1 << 52)


def test_f64_columns_start_values_cancel_every_exponent():
    """Each column takes 2 pairs(c) low and 2 pairs(c - 1) high patterns
    (the product's and the reduction's), 50 of each in all."""
    assert sum(2 * pairs(c) for c in range(COLS)) == 2 * LIMBS * LIMBS
    assert sum(2 * pairs(c - 1) for c in range(COLS)) == 2 * LIMBS * LIMBS
    assert max(2 * pairs(c) + 2 * pairs(c - 1) for c in range(COLS)) == 18
    # 18 terms below 2^52 and a carry below 2^6: far below 2^64
    assert 18 * M52 + (1 << 6) < 1 << 57


def test_the_models_constants_are_the_sources():
    """fr.cuh's immediates and tables for the two products, against p."""
    import re
    import struct

    src = (K.CSRC / "fr.cuh").read_text()

    def define(name):
        return int(re.search(rf"#define {name} 0x([0-9a-fA-F]+)u", src).group(1), 16)

    assert [define(f"FR_P{k}") for k in range(8)] == PW
    assert define("FR_NPRIME32") == NP32
    assert define("F52_NP") == NP52 and define("F52_MASK") == M52
    assert define("F52_LO_BITS") == LO_BITS == struct.unpack("<Q", struct.pack("<d", 2.0 ** 52))[0]
    assert define("F52_HI_BITS") == HI_BITS == struct.unpack("<Q", struct.pack("<d", 2.0 ** 104))[0]
    body = re.search(r"FR_P52\[F52_LIMBS\]\s*=\s*\{([^}]*)\}", src).group(1)
    assert [int(w, 16) for w in re.findall(r"0x([0-9a-fA-F]+)ull", body)] == P52
