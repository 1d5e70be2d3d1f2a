"""A model of the round eval kernels `k_eval<4>` and `k_eval<3>`
(gkr_tpu_torch/csrc/kernels.cu: `phase*_partials` and `phase*_eval`), in
pure Python, against their plain versions and the JAX package.

The kernels take entry s of lo and hi in tile s // EVAL_TILE, which goes to
block (s // EVAL_TILE) % G.  Per entry they add three canonical Montgomery
products u_t W_t / R and the linear terms at lo and hi into 9-word lazy
accumulators; a block folds them (warp shuffles, then across warps),
reduces each mod p once and writes
  y_t = V_t + c L_t,  L_2 = 2 L_1 - L_0,
with u = HA1 + HM, l = HA2, c = 1 in phase 1, and u = FA + FMwb, l = FA,
c = wb (one Montgomery product) in phase 2: phase 2's factored form of the
JAX formula FA_t (wb + W_t) + FMwb_t W_t.  The model computes the same
integers in that order and is held to the plain versions (the JAX formulas,
entry by entry; test_torch_limbs.py holds those to JAX) and, for phase 2,
to gkr_tpu.jaxeng.sumcheck's jitted `_phase2_eval`; a word-level
model of the accumulators asserts that no carry is lost at the largest
tables.  Every comparison is exact."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gkr_tpu.field import P, R
from gkr_tpu.jaxeng import sumcheck as JS

from gkr_tpu_torch.convert import limbs_from_numpy, limbs_to_numpy
from gkr_tpu_torch.torcheng import kernels as K
from gkr_tpu_torch.torcheng import limbs as L

TILE, GMAX = K.EVAL_TILE, K.EVAL_MAX_BLOCKS
WARPS = TILE // 32
M32 = (1 << 32) - 1
R_INV = pow(R, P - 2, P)
EDGE = [0, 1, 2, P - 1, P - 2, P // 2, R % P, (1 << 253) - 1, P - (1 << 16)]
# (U_A, U_B, LIN) of each phase's stack: u = X[U_A] + X[U_B], l = X[LIN]
LAYOUT = {1: (1, 3, 2), 2: (1, 2, 1)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs its files in parallel workers; torch's intra-op threads
    buy these small limb tensors nothing and take cores from the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def stack_values(rng, half, T):
    """2 half entries of T canonical values (taken as Montgomery limbs as
    they are), edge values in the first entries of lo and of hi."""
    raw = rng.bytes(32 * 2 * half * T)
    vals = [int.from_bytes(raw[32 * i:32 * i + 32], "little") % P
            for i in range(2 * half * T)]
    k = min(len(EDGE), half * T)
    vals[:k] = EDGE[:k]
    vals[half * T:half * T + k] = EDGE[::-1][:k]
    S = torch.from_numpy(L.canonical_limbs(vals)).reshape(2 * half, T, 16)
    return S, [vals[T * s:T * s + T] for s in range(2 * half)]


def mont(x, y):
    return x * y * R_INV % P


def model_partials(entries, phase, wb=None):
    """The kernel's arithmetic: (G, 3) canonical block sums."""
    half = len(entries) // 2
    ua, ub, lin = LAYOUT[phase]
    G = K._eval_grid(half)
    V = [[0, 0, 0] for _ in range(G)]
    Lsum = [[0, 0] for _ in range(G)]
    for s in range(half):
        b = (s // TILE) % G
        lo, hi = entries[s], entries[half + s]
        u0, u1 = (lo[ua] + lo[ub]) % P, (hi[ua] + hi[ub]) % P
        w2, u2 = (2 * hi[0] - lo[0]) % P, (2 * u1 - u0) % P
        for t, (u, w) in enumerate(((u0, lo[0]), (u1, hi[0]), (u2, w2))):
            V[b][t] += mont(u, w)
        Lsum[b][0] += lo[lin]
        Lsum[b][1] += hi[lin]
    out = []
    for b in range(G):
        l0, l1 = Lsum[b][0] % P, Lsum[b][1] % P
        ls = [l0, l1, (2 * l1 - l0) % P]
        if phase == 2:
            ls = [mont(x, wb) for x in ls]
        out.append([(V[b][t] + ls[t]) % P for t in range(3)])
    return out


def kernel_wrappers(phase, S, wbt):
    if phase == 1:
        return K.phase1_partials(S), K.phase1_eval(S)
    return K.phase2_partials(S, wbt), K.phase2_eval(S, wbt)


@pytest.mark.parametrize("phase", [1, 2])
@pytest.mark.parametrize("half, grid", [(1, GMAX), (TILE - 5, GMAX), (2 * TILE + 3, GMAX),
                                        (4 * TILE + 7, 3)],
                         ids=["half=1", "half<tile", "ragged", "tiles>grid"])
def test_schedule_and_factored_sums_match_plain(phase, half, grid, monkeypatch):
    """The kernel's block schedule and factored sums, in Python ints, equal
    the plain versions' partials (the JAX formula entry by entry) at half =
    1, less than a tile, a ragged 2 tiles + 3, and 5 tiles on a grid cut to
    3 blocks (blocks 0 and 1 take two tiles, the last one ragged; the card
    check in chip_smoke.py wraps the real grid at 2^16 and 2^20)."""
    monkeypatch.setattr(K, "EVAL_MAX_BLOCKS", grid)
    rng = np.random.default_rng(70 + phase + half)
    T = 4 if phase == 1 else 3
    S, entries = stack_values(rng, half, T)
    wb = int.from_bytes(rng.bytes(32), "little") % P
    wbt = torch.from_numpy(L.canonical_limbs([wb]))[0]
    want = model_partials(entries, phase, wb)
    part, ev = kernel_wrappers(phase, S, wbt)
    G = K._eval_grid(half)
    assert G == min(grid, -(-half // TILE))
    assert part.shape == (G, 3, 16)
    assert L.unpack(part, montgomery=False) == [x for row in want for x in row]
    sums = [sum(row[t] for row in want) % P for t in range(3)]
    assert L.unpack(ev, montgomery=False) == sums


@pytest.mark.parametrize("wb", [0, 1, P - 1, None], ids=["0", "1", "p-1", "random"])
def test_phase2_factored_sum_matches_jax(wb):
    """(sum FA) wb + sum W (FA + FMwb), block by block, summed: JAX's
    `_phase2_eval` (FA (wb + W) + FMwb W), with edge limbs, at wb = 0, 1,
    p - 1 and a random value (as Montgomery limbs)."""
    rng = np.random.default_rng(80)
    half = TILE + 3
    S, entries = stack_values(rng, half, 3)
    if wb is None:
        wb = int.from_bytes(rng.bytes(32), "little") % P
    wbt = torch.from_numpy(L.canonical_limbs([wb]))[0]
    model = model_partials(entries, 2, wb)
    assert L.unpack(K.phase2_partials_plain(S, wbt), montgomery=False) == \
        [x for row in model for x in row]
    want = JS._phase2_eval(jnp.asarray(limbs_to_numpy(S)),
                           jnp.asarray(limbs_to_numpy(wbt)))
    sums = [sum(row[t] for row in model) % P for t in range(3)]
    assert L.unpack(limbs_from_numpy(np.asarray(want)), montgomery=False) == sums


# ------------------------------------------------- the accumulators, by word

def words(v, n=9):
    return [(v >> (32 * j)) & M32 for j in range(n)]


def value(ws):
    return sum(w << (32 * j) for j, w in enumerate(ws))


def acc9_add(a, b):
    """kernels.cu `acc9_add`: 9 words plus 9 (or a canonical element's 8), one
    carry chain; the last `addc.u32` drops a carry out of word 8, which the
    model asserts never happens."""
    out, c = [], 0
    for j in range(9):
        s = a[j] + (b[j] if j < len(b) else 0) + c
        out.append(s & M32)
        c = s >> 32
    assert c == 0, "a lazy sum lost its carry out of word 8"
    return out


def test_acc9_add_is_exact_below_2_288():
    rng = np.random.default_rng(82)
    top = (1 << 288) - 1
    cases = [(0, 0), (top - (P - 1), P - 1), ((1 << 256) - 1, (1 << 256) - 1),
             ((1 << 287), (1 << 287) - 1)]
    cases += [(int.from_bytes(rng.bytes(36), "little") >> 1,
               int.from_bytes(rng.bytes(32), "little") % P) for _ in range(200)]
    for a, b in cases:
        n = 8 if b < 1 << 256 else 9
        assert value(acc9_add(words(a), words(b, n))) == a + b
    with pytest.raises(AssertionError):
        acc9_add(words(top), words(1, 8))


def shuffle_down_sum(lanes):
    """The kernel's warp fold: for off = 16, 8, 4, 2, 1 each lane adds
    __shfl_down_sync(v, off), its own value where lane + off > 31.  Only
    the lanes below `off` feed lane 0: their sums must be exact."""
    v = list(lanes)
    for off in (16, 8, 4, 2, 1):
        v = [acc9_add(v[l], v[l + off]) if l < off else v[l]
             for l in range(32)]
    return v[0]


@pytest.mark.parametrize("half", [1, 1 << 20, 1 << 40])
def test_lazy_accumulators_never_overflow(half):
    """At every table up to 2^40 entries a half (far past any the card
    holds), each thread's accumulator, every step of the warp fold and the
    cross-warp sum stay below 2^288, and the block sum below p 2^256, the
    contract of the reduction (REDC, `fr_redc_wide`): every term is a
    canonical value, at most p - 1, and a thread takes one entry a tile."""
    n_tiles = -(-half // TILE)
    G = K._eval_grid(half)
    per_thread = -(-n_tiles // G)
    biggest = per_thread * (P - 1)
    thread = words(0)
    for chunk in range(min(per_thread, 64)):     # word-level: the first adds
        thread = acc9_add(thread, words(P - 1, 8))
    assert value(thread) == min(per_thread, 64) * (P - 1)
    lanes = [words(biggest)] * 32
    warp = shuffle_down_sum(lanes)
    assert value(warp) == 32 * biggest
    block = warp
    for _ in range(WARPS - 1):
        block = acc9_add(block, warp)
    assert value(block) == TILE * biggest < P << 256
    # the cross-block sums of round_tail and the one-launch eval: 16-bit
    # limbs in 32-bit lanes over at most TAIL_MAX_G partials
    assert K.TAIL_MAX_G * 0xFFFF < 1 << 32 and GMAX <= K.TAIL_MAX_G


# ------------------------------------------ the lazy operand of phase 2's t = 2

NPRIME32 = (-pow(P, -1, 1 << 32)) % (1 << 32)        # fr.cuh FR_NPRIME32
P_WORDS = words(P, 8)


def fr_twice_minus(a, b):
    """fr.cuh `fr_twice_minus`: p - b by one borrow chain, then + a + a by
    one carry chain; 2a - b + p, not reduced."""
    d, borrow = [], 0
    for j in range(8):
        v = P_WORDS[j] - words(b, 8)[j] - borrow
        d.append(v & M32)
        borrow = 1 if v < 0 else 0
    assert borrow == 0
    out, carry = [], 0
    for j in range(8):
        v = d[j] + 2 * words(a, 8)[j] + carry
        out.append(v & M32)
        carry = v >> 32
    assert carry == 0
    return value(out)


def fr_mul_cios(a, b):
    """fr.cuh `fr_mul`, word by word: CIOS with t[10], asserting that no
    64-bit sum overflows, that t[8] is clear at the end and that one
    conditional subtraction leaves the result canonical."""
    A, B = words(a, 8), words(b, 8)
    t = [0] * 10
    for i in range(8):
        c = 0
        for j in range(8):
            s = t[j] + A[j] * B[i] + c
            assert s < 1 << 64
            t[j], c = s & M32, s >> 32
        s = t[8] + c
        t[8], t[9] = s & M32, s >> 32
        m = (t[0] * NPRIME32) & M32
        s = t[0] + m * P_WORDS[0]
        assert s & M32 == 0
        c = s >> 32
        for j in range(1, 8):
            s = t[j] + m * P_WORDS[j] + c
            assert s < 1 << 64
            t[j - 1], c = s & M32, s >> 32
        s = t[8] + c
        t[7] = s & M32
        t[8] = t[9] + (s >> 32)
    assert t[8] == 0
    r = value(t[:8])
    assert r < 2 * P
    return r - P if r >= P else r


def test_phase2_lazy_operand_keeps_the_product_canonical():
    """Phase 2's t = 2 (and phase 1's) multiplies W_2 = 2 W_1 - W_0 + p,
    below 3p and not reduced, by the canonical u_2: the CIOS product's
    words and its one conditional subtraction still give a b / R mod p."""
    rng = np.random.default_rng(83)
    rand = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(60)]
    pairs = [(P - 1, 0), (P - 1, 1), (0, P - 1), (P // 2, P // 2 + 1)]
    pairs += list(zip(rand[:30], rand[30:]))
    us = [0, 1, P - 1, R % P] + rand[:20]
    for w1, w0 in pairs:
        w2 = fr_twice_minus(w1, w0)
        assert w2 < 3 * P and w2 % P == (2 * w1 - w0) % P
        for u in us:
            assert fr_mul_cios(w2, u) == w2 * u * R_INV % P
    for a in (3 * P - 2, 3 * P - 1, 2 * P, (1 << 255) + 12345):
        assert fr_mul_cios(a, P - 1) == a * (P - 1) * R_INV % P


def test_kernel_sizes_match_the_source():
    """The plain versions' block schedule and the wrappers' checks read the
    sizes that csrc/kernels.cu defines; a drift would otherwise show only in
    the card's bit-equal checks."""
    src = (K.CSRC / "kernels.cu").read_text()
    defined = {m.group(1): int(m.group(2))
               for m in re.finditer(r"^#define (\w+) (\d+)\b", src, re.M)}
    assert {k: defined[k] for k in ("THREADS", "EVAL_TILE", "TAIL_MAX_G", "SEG_LIMBS",
                                    "EQ_BITS", "EQ_MAX_K")} \
        == {"THREADS": K.THREADS, "EVAL_TILE": K.EVAL_TILE,
            "TAIL_MAX_G": K.TAIL_MAX_G, "SEG_LIMBS": K.SEG_LIMBS,
            "EQ_BITS": K.EQ_BITS, "EQ_MAX_K": K.EQ_MAX_K}
    assert K.EVAL_TILE % 32 == 0 and K.EVAL_MAX_BLOCKS <= K.TAIL_MAX_G
