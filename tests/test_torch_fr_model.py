"""A word-level model of the hash's Montgomery product `fr_mul_lat` and of
the device MiMC7 schedule (gkr_tpu_torch/csrc/fr.cuh, csrc/kernels.cu), in
pure Python.

The hash runs on 9 limbs of 29 bits (`Fr29`) with Montgomery radix
2^261: a value v stands for v * 2^-261 mod p, and an element in the
kernels' form x R mod p (R = 2^256) enters as 32 x R (a 5-bit shift) and
leaves through one product by 2^256 mod p.  The model keeps the CUDA
source's limbs, its 17 64-bit column sums, the order of its reduction steps
and carries, and asserts every bound the source states: each column below
2^64, the column a reduction step clears divisible by 2^29, each limb of
an input below 2^30 and of an output below 2^29, every value below 2^260.
An overflow shows here before any chip run.  Results are held to
a * b * 2^-261 mod p (the product and the square), the x^2 -> {x^3, x^4}
-> x^7 schedule to x^7 mod p,
and the whole device hash to the JAX package's host Mimc7; every comparison
is exact."""

import numpy as np
import pytest

from gkr_tpu.field import P, R
from gkr_tpu.mimc import Mimc7 as JaxMimc7

from gkr_tpu_torch.torcheng import kernels as K

LIMBS, BITS = 9, 29
M29 = (1 << BITS) - 1
M64 = 1 << 64
NP29 = 0x0FFFFFFF                    # fr.cuh FR_NP29: -p^-1 mod 2^29
R29 = 1 << (LIMBS * BITS)            # 2^261
BOUND = 1 << 260                     # values in and out of fr_mul_lat
R29_INV = pow(R29, P - 2, P)
R_INV = pow(R, P - 2, P)


def limbs29(v: int) -> list[int]:
    assert 0 <= v < R29
    return [(v >> (BITS * k)) & M29 for k in range(LIMBS)]


def value29(limbs: list[int]) -> int:
    return sum(x << (BITS * k) for k, x in enumerate(limbs))


P29 = limbs29(P)
C256 = limbs29((1 << 256) % P)       # fr.cuh FR_C256_29


def fr29_redc(c: list[int]) -> list[int]:
    """fr.cuh `fr29_redc`: 17 columns -> 9 limbs of T 2^-261 mod p."""
    for i in range(LIMBS):
        m = ((c[i] & 0xFFFFFFFF) * NP29) & M29
        for j in range(LIMBS):
            c[i + j] += m * P29[j]
            assert c[i + j] < M64
        assert c[i] & M29 == 0
        c[i + 1] += c[i] >> BITS
        assert c[i + 1] < M64
    out, v = [], c[LIMBS]
    for k in range(LIMBS + 1, 17):
        out.append(v & M29)
        v = c[k] + (v >> BITS)
        assert v < M64
    out += [v & M29, v >> BITS]
    assert out[-1] <= M29
    return out


def check_inputs(*xs: list[int]) -> None:
    for x in xs:
        assert all(v < 1 << 30 for v in x) and value29(x) < BOUND


def check_output(r: list[int], a: list[int], b: list[int]) -> list[int]:
    assert value29(r) < BOUND
    assert value29(r) % P == value29(a) * value29(b) * R29_INV % P
    return r


def fr_mul_lat(a: list[int], b: list[int]) -> list[int]:
    """fr.cuh `fr_mul_lat`: limbs of a value congruent to a * b * 2^-261
    mod p; a, b below 2^260 with limbs below 2^30."""
    check_inputs(a, b)
    c = [0] * 17
    for i in range(LIMBS):
        for j in range(LIMBS):
            c[i + j] += a[i] * b[j]
            assert c[i + j] < M64
    return check_output(fr29_redc(c), a, b)


def fr_sqr_lat(a: list[int]) -> list[int]:
    """fr.cuh `fr_sqr_lat`: the square from the diagonal and the cross
    terms against the doubled limbs."""
    check_inputs(a)
    d = [x << 1 for x in a]
    assert all(x < 1 << 32 for x in d)
    c = [0] * 17
    for i in range(LIMBS):
        c[2 * i] += a[i] * a[i]
        for j in range(i + 1, LIMBS):
            c[i + j] += a[i] * d[j]
            assert c[i + j] < M64
    return check_output(fr29_redc(c), a, a)


def fr29_from_fr(x: int) -> list[int]:
    """fr.cuh `fr29_from_fr`: x R mod p (canonical) -> the limbs of 32 x R,
    the same element at radix 2^261."""
    assert 0 <= x < P
    return limbs29(x << 5)


def fr29_to_fr(a: list[int]) -> int:
    """fr.cuh `fr29_to_fr`: one product by 2^256 mod p (below 1.5 p), eight
    words, one conditional subtraction."""
    v = value29(fr_mul_lat(a, C256))
    assert v < 1.5 * P
    return v - P if v >= P else v


def fr29_add(a: list[int], b: list[int]) -> list[int]:
    """fr.cuh `fr29_add_lazy`: limb by limb, no carry."""
    return [x + y for x, y in zip(a, b)]


def fr_pow7(x: list[int]) -> list[int]:
    """fr.cuh `fr_pow7`: x^2, then x^3 and x^4 (independent), then x^3 x^4;
    x^2 and x^4 are squares."""
    x2 = fr_sqr_lat(x)
    x3 = fr_mul_lat(x2, x)
    x4 = fr_sqr_lat(x2)
    return fr_mul_lat(x3, x4)


def mimc_multi(xs: list[int]) -> int:
    """kernels.cu `mimc_multi_block` on host ints: for each element the key
    table kc_i = (r + c_i) mod p in radix 2^261, then h = x and 91 rounds
    of h = (h + kc_i)^7 with the sum taken limb by limb, then, back in the
    kernels' form, r = r + x + (h + r) mod p."""
    cts = [c * R % P for c in JaxMimc7(K.MIMC_ROUNDS).cts]
    r = 0
    for x in xs:
        x = x * R % P
        kc = [fr29_from_fr((r + c) % P) for c in cts]
        h = fr29_from_fr(x)
        for k in kc:
            h = fr_pow7(fr29_add(h, k))
        r = (r + x + fr29_to_fr(h) + r) % P
    return r * R_INV % P


def edge_values() -> list[int]:
    """0, 1, p - 1, p - 2, R mod p, and values whose words are all ones
    below p."""
    return [0, 1, P - 1, P - 2, R % P, (1 << 253) - 1, (1 << 224) - 1,
            (1 << 128) - 1, P - (1 << 32)]


def rand_field(rng, n: int, bound: int = P) -> list[int]:
    raw = rng.bytes(33 * n)
    return [int.from_bytes(raw[33 * i:33 * i + 33], "little") % bound
            for i in range(n)]


def mont(x: int, y: int) -> int:
    """What fr_mul (R = 2^256) computes on the kernels' canonical values."""
    return x * y * R_INV % P


def test_word_model_matches_fr_mul_on_edges():
    """Through the conversions the product and the square are fr_mul's,
    canonical."""
    edges = edge_values()
    for a in edges:
        assert fr29_to_fr(fr_sqr_lat(fr29_from_fr(a))) == mont(a, a)
        for b in edges:
            assert fr29_to_fr(fr_mul_lat(fr29_from_fr(a), fr29_from_fr(b))) == mont(a, b)


def test_word_model_matches_fr_mul_on_random_pairs():
    rng = np.random.default_rng(70)
    for a, b in zip(rand_field(rng, 2000), rand_field(rng, 2000)):
        assert fr29_to_fr(fr_mul_lat(fr29_from_fr(a), fr29_from_fr(b))) == mont(a, b)
        assert fr29_to_fr(fr_sqr_lat(fr29_from_fr(a))) == mont(a, a)


def test_word_model_takes_its_largest_inputs():
    """Values just below 2^260, limbs at 2^30 - 1 (a lazy sum of two
    outputs), and random values below 2^260 keep every bound."""
    rng = np.random.default_rng(71)
    top = [limbs29(BOUND - 1), limbs29(BOUND - P), [(1 << 30) - 1] * 8 + [0],
           fr29_add(limbs29((1 << 259) - 1), limbs29(32 * (P - 1)))]
    rand = [limbs29(v) for v in rand_field(rng, 300, BOUND)]
    for a in top + rand:
        fr_sqr_lat(a)
        for b in top + [limbs29(v) for v in edge_values()]:
            fr_mul_lat(a, b)


@pytest.mark.parametrize("start", ["fresh", "lazy"])
def test_pow7_schedule_matches_pow(start):
    """From a converted element, and from the largest sum a round can make
    of the same residue: an output just below 2^259 + p plus a key of
    31 p, limb by limb."""
    rng = np.random.default_rng(72 if start == "fresh" else 73)
    for x in edge_values() + rand_field(rng, 100):
        t = fr29_from_fr(x * R % P)
        if start == "lazy":
            v = value29(t)
            h = v + ((1 << 259) + P - 1 - v) // P * P
            t = fr29_add(limbs29(h), limbs29(31 * P))
        assert fr29_to_fr(fr_pow7(t)) == pow(x, 7, P) * R % P


def test_device_hash_schedule_matches_host_mimc7():
    rng = np.random.default_rng(74)
    m = JaxMimc7()
    for xs in ([0, 1, P - 1], rand_field(rng, 2)):
        assert mimc_multi(xs) == m.multi_hash(xs, 0)
