"""The port's fused layer sumcheck and the plain versions of its kernels,
against the JAX package on the CPU.

Transcripts are held to gkr_tpu's exact host engine; kernel-level values
to small jitted XLA pieces of gkr_tpu.jaxeng (the wiring plan, the cumsum
segment sum, normalize, the round interpolation) and to host ints; the eq
table's plain version is held to the JAX limb engine in
test_torch_limbs.py.  Inputs come from numpy seeds and reach both packages as the same
limbs.  Field arithmetic has no rounding: every check is exact equality of
canonical integers."""

import random
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gkr_tpu
from gkr_tpu.field import P, R
from gkr_tpu.field import interpolate as jax_interpolate
from gkr_tpu.jaxeng import fused as JF
from gkr_tpu.jaxeng import limbs as JL
from gkr_tpu.mimc import Mimc7 as JaxMimc7
from gkr_tpu.mle import mle_struct as jax_mle_struct
from gkr_tpu.sumcheck import prove_layer_sumcheck as jax_layer_sumcheck

import gkr_tpu_torch as port
from gkr_tpu_torch.convert import circuit_from, limbs_from_numpy, limbs_to_numpy
from gkr_tpu_torch.mimc import Mimc7
from gkr_tpu_torch.mle import mle_struct
from gkr_tpu_torch.torcheng import fused as F
from gkr_tpu_torch.torcheng import kernels as K
from gkr_tpu_torch.torcheng import limbs as L

from test_gkr_e2e import (assert_proofs_identical, random_circuit,
                          reference_toy_circuit)

ROOT = Path(__file__).resolve().parent.parent
EDGE = [0, 1, 2, P - 1, P - 2, P // 2, R % P, (1 << 253) - 1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs its files in parallel workers; torch's intra-op threads
    buy these small limb tensors nothing and take cores from the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rand_field(rng, n):
    raw = rng.bytes(32 * n)
    return [int.from_bytes(raw[32 * i:32 * i + 32], "little") % P
            for i in range(n)]


def value(limbs) -> int:
    return sum(int(x) << (16 * i) for i, x in enumerate(limbs))


def no_launches():
    return all(v == 0 for v in K.LAUNCHES.values())


def random_gates(rng, n_gates, n_out, n_in, hot=None):
    gates = [(int(rng.integers(n_out)), int(rng.integers(n_in)),
              int(rng.integers(n_in))) for _ in range(n_gates)]
    if hot is not None:                       # (count, left key, right key)
        count, left, right = hot
        for i in range(count):
            o, _, _ = gates[i]
            gates[i] = (o, left, right)
    return gates


# ------------------------------------------------------------ wiring plan

@pytest.mark.parametrize("case", ["random", "low_buckets"])
def test_wiring_plan_matches_build_wiring(case):
    """Sorted index columns and bucket boundaries of both phases equal the
    JAX plan's (its columns are padded past the real gates with key n; the
    port keeps no padding).  "low_buckets": power-of-two gate counts all in
    the low output buckets, every trailing bucket empty."""
    rng = np.random.default_rng(3)
    n = 1 << 11
    if case == "random":
        ag = random_gates(rng, n // 2, 16, n)
        mg = random_gates(rng, n // 3, 16, n)
    else:
        ag = [(g & 7, int(rng.integers(n)), int(rng.integers(n)))
              for g in range(n // 2)]
        mg = [(g & 7, int(rng.integers(n)), int(rng.integers(n)))
              for g in range(n // 2)]
    want = JF.build_wiring(ag, mg, n)
    got = F.build_wiring(ag, mg, n)
    for plan, out, other, hib, count in (
            (got.a1, want.a1_out, want.a1_in, want.a1_hib, len(ag)),
            (got.m1, want.m1_out, want.m1_in, want.m1_hib, len(mg)),
            (got.a2, want.a2_out, want.a2_l, want.a2_hib, len(ag)),
            (got.m2, want.m2_out, want.m2_l, want.m2_hib, len(mg))):
        assert plan.hib.dtype == torch.int32 and plan.hib.shape == (n,)
        assert np.array_equal(plan.hib.numpy(), np.asarray(hib))
        assert np.array_equal(plan.out.numpy(), np.asarray(out)[:count])
        assert np.array_equal(plan.other.numpy(), np.asarray(other)[:count])
    empty = F.build_wiring(ag, [], n)
    assert empty.m1 is None and empty.m2 is None and empty.a1 is not None


# ------------------------------------------------------------ segment sum

def _sorted_plan(keys, n):
    keys = np.sort(np.asarray(keys))
    return keys, np.searchsorted(keys, np.arange(n), side="right").astype(np.int32)


@pytest.mark.parametrize("fast", [True, False])
def test_seg_sum_plain_matches_seg_sorted_T(fast):
    """Bucket values of the port's 18-limb sums equal those of the JAX
    cumsum segment sum (both of its paths) on the same sorted weights."""
    rng = np.random.default_rng(22)
    n, G = 16, 64
    keys = rng.integers(0, n, size=G)
    keys[:20] = 3                                   # collisions, near-max limbs
    keys, hib = _sorted_plan(keys, n)
    vals = [rand_field(rng, G) for _ in range(2)]
    vals[0][:20] = [P - 1 - i % 4 for i in range(20)]
    jw = [JL.pack(v) for v in vals]
    want = jax.jit(lambda h, a, b: JF._seg_sorted_T(h, [a.T, b.T], n, fast=fast))(
        jnp.asarray(hib), *jw)
    got = K.seg_sum([limbs_from_numpy(np.asarray(w)) for w in jw],
                    torch.from_numpy(hib))
    assert got.shape == (2, K.SEG_LIMBS, n) and int(got.max()) < (1 << 16)
    for t in range(2):
        assert [value(c) for c in got[t].T.tolist()] == \
            [value(c) for c in np.asarray(want[t]).T.tolist()]


def test_seg_sum_hot_bucket_carry():
    """70,000 gates in one bucket with every limb near 0xFFFF: the per-limb
    column sums pass 2^32, so the carries must reach limbs 16 and 17.  The
    regression pin of the JAX package's hot-bucket carry fix."""
    n, G = 4, 70000
    w = L.pack([P - 1] * G)
    hib = torch.tensor([0, G, G, G], dtype=torch.int32)
    got = K.seg_sum([w, w], hib)
    raw = value(L.canonical_limbs([(P - 1) * R % P])[0])
    for t in range(2):
        assert [value(c) for c in got[t].T.tolist()] == [0, G * raw, 0, 0]
    assert int(got[0, 16, 1]) > 0                   # carried past limb 15
    assert L.unpack(K.normalize(got[0])) == [0, G * (P - 1) % P, 0, 0]


# ---------------------------------------------------------------- normalize

def _relaxed_at_limits(rng, lin, n):
    """(lin, n) relaxed limbs below 2^31 with value < p * 2^256: random
    limbs near 2^31 under a clean top, plus columns at the edges."""
    t = rng.integers((1 << 31) - (1 << 20), 1 << 31, size=(lin, n))
    if lin == 32:
        t[30:] = 0
    top = (P << 256) - 1
    near = [(1 << 31) - (1 << 16) - 1] * (lin - 2) + [0, 0]
    base = value(near)
    edges = [top, top - (1 << 255), (1 << 288) - 1, P, 0] if lin == 32 else \
        [(1 << 288) - 1, P, 1, 0]
    for i, v in enumerate(edges):
        low, rest = (near, v - base) if v >= base else ([0] * lin, v)
        t[:, i] = [b + ((rest >> (16 * j)) & 0xFFFF) for j, b in enumerate(low)]
        assert value(t[:, i]) == v
    return t


@pytest.mark.parametrize("lin", [18, 32])
def test_normalize_plain_matches_jax_normalize_relaxed(lin):
    rng = np.random.default_rng(30 + lin)
    t = _relaxed_at_limits(rng, lin, 64)
    want = np.asarray(JL.jnormalize(jnp.asarray(t.T.astype(np.uint32))))
    tt = torch.from_numpy(t.astype(np.int32))
    got = K.normalize(tt)
    assert np.array_equal(limbs_to_numpy(got), want)
    assert L.unpack(got, montgomery=False) == [value(c) % P for c in t.T]
    s = rand_field(rng, 1)[0]
    js, ts = JL.pack_scalar(s), L.pack_scalar(s)
    assert np.array_equal(limbs_to_numpy(K.normalize(tt, ts)), np.asarray(
        JL.jmul(jnp.asarray(want), jnp.broadcast_to(js, want.shape))))
    with pytest.raises(ValueError):
        K.normalize(tt.to(torch.int64))


# ------------------------------------------------------------------ rounds

@pytest.mark.parametrize("G", [1, 3, 7])
def test_round_coeffs_plain_matches_interp3_and_host(G):
    """The round tail's coefficients (its plain version, `round_coeffs_plain`,
    on the CPU): the cross-block sum and the interpolation."""
    rng = np.random.default_rng(40 + G)
    vals = rand_field(rng, 3 * G)
    vals[:min(len(EDGE), 3 * G)] = EDGE[:3 * G]
    part = L.pack(vals).reshape(G, 3, 16)
    got, _ = K.round_tail(part, 3)
    assert torch.equal(got, K.round_coeffs_plain(part))
    y = [sum(vals[t::3]) % P for t in range(3)]
    jy = JL.pack(y)
    want = jnp.stack(jax.jit(JF._interp3)(jy[0], jy[1], jy[2]))
    assert np.array_equal(limbs_to_numpy(got), np.asarray(want))
    assert L.unpack(got) == jax_interpolate(list(zip(range(3), y)))


@pytest.mark.parametrize("G, length", [(1, 2), (1, 3), (1024, 2), (1024, 3)])
def test_round_tail_plain_matches_interp3_and_host_mimc7(G, length):
    """round_tail: the coefficients of `_interp3` and, as the challenge, the
    host Mimc7 of the round's last `length` of them; G = 1024 partials of
    p - 1 are the largest sums the kernel's lazy limb sums take."""
    rng = np.random.default_rng(45 + G + length)
    vals = [P - 1] * (3 * G) if G == 1024 else rand_field(rng, 3 * G)
    part = L.pack(vals).reshape(G, 3, 16)
    co, r = K.round_tail(part, length)
    assert co.shape == (3, 16) and r.shape == (16,)
    y = [sum(vals[t::3]) % P for t in range(3)]
    jy = JL.pack(y)
    want = jnp.stack(jax.jit(JF._interp3)(jy[0], jy[1], jy[2]))
    assert np.array_equal(limbs_to_numpy(co), np.asarray(want))
    coeffs = L.unpack(co)[3 - length:]
    assert L.unpack_scalar(r) == JaxMimc7().multi_hash(coeffs, 0)
    with pytest.raises(ValueError):
        K.round_tail(part, 4)


def test_mimc_multi_plain_matches_host_mimc7():
    rng = np.random.default_rng(50)
    m = JaxMimc7()
    for arr in ([0, 1], [P - 1, P - 1], [0, 1, P - 1], [P - 1, 0, 1],
                rand_field(rng, 2), rand_field(rng, 3)):
        got = K.mimc_multi(L.pack(arr))
        assert got.shape == (16,)
        assert L.unpack_scalar(got) == m.multi_hash(arr, 0)
    assert K.MIMC_ROUNDS == m.n_rounds == 91
    assert L.unpack(K._mimc_constants(torch.device("cpu"))) == list(m.cts)


@pytest.mark.parametrize("phase", [1, 2])
def test_partials_plain_are_block_sums(phase):
    """Each (3, 16) partial is the sum mod p of the entries its block of the
    eval kernel's grid visits; their sum is the round's evaluation."""
    rng = np.random.default_rng(60 + phase)
    half, T = 600, (4 if phase == 1 else 3)
    S = L.pack(rand_field(rng, 2 * half * T)).reshape(2 * half, T, 16)
    wb = L.pack_scalar(rand_field(rng, 1)[0])
    part = K.phase1_partials(S) if phase == 1 else K.phase2_partials(S, wb)
    terms = (K._phase1_terms_plain(S) if phase == 1
             else K._phase2_terms_plain(S, wb))
    G = K._eval_grid(half)
    assert part.shape == (G, 3, 16) == (3, 3, 16)
    tv = [L.unpack(terms[t]) for t in range(3)]
    want = [[sum(tv[t][s] for s in range(half) if (s // K.THREADS) % G == b) % P
             for t in range(3)] for b in range(G)]
    assert L.unpack(part) == [x for row in want for x in row]
    ev = K.phase1_eval(S) if phase == 1 else K.phase2_eval(S, wb)
    assert torch.equal(L.sum_mod(part), ev)


@pytest.mark.parametrize("absent", [(), (3,), (1, 2)])
def test_stack_plain_matches_jax_transposed_stack(absent):
    """The builds' stack: W and the tables into (n, T, 16), the transpose of
    the JAX builds' limb-major (T, 16, n) stack of pl_transpose_T(W) and the
    tables; an absent (None) table is the JAX build's zero table."""
    from gkr_tpu.jaxeng import pallas_kernels as PK

    rng = np.random.default_rng(65 + len(absent))
    n, T = 8, 4
    vals = rand_field(rng, n * T)
    vals[:len(EDGE)] = EDGE
    rows = [np.asarray(JL.pack(vals[j * n:(j + 1) * n])) for j in range(T)]
    for j in absent:
        rows[j] = np.zeros_like(rows[j])
    want = np.transpose(np.asarray(jnp.stack(
        [PK.pl_transpose_T(jnp.asarray(r)) for r in rows])), (2, 0, 1))
    tables = [None if j in absent else limbs_from_numpy(r)
              for j, r in enumerate(rows)]
    K.reset_launches()
    got = K.stack(tables)
    assert no_launches()
    assert got.shape == (n, T, 16)
    assert np.array_equal(limbs_to_numpy(got), want)
    assert torch.equal(K.stack(tables[:3]), got[:, :3])
    with pytest.raises(ValueError):
        K.stack([None, None])
    with pytest.raises(ValueError):
        K.stack([tables[0], tables[0][:4]])


def test_new_constants_of_fr_cuh():
    src = (ROOT / "gkr_tpu_torch" / "csrc" / "fr.cuh").read_text()
    for name, want in (("FR_ONE", R % P), ("FR_R2", R * R % P)):
        body = re.search(name + r"\[8\]\s*=\s*\{([^}]*)\}", src).group(1)
        words = [int(w, 16) for w in re.findall(r"0x([0-9a-fA-F]+)u", body)]
        assert len(words) == 8 and value_words(words) == want


def value_words(words):
    return sum(w << (32 * i) for i, w in enumerate(words))


# ------------------------------------------------------------- fused layer

LAYERS = {
    # name: (k, k_cur, n_add, n_mult, hot)
    "toy": (2, 1, 3, 2, None),
    "random": (5, 3, 24, 17, None),
    "add_only_sparse": (6, 2, 9, 0, None),
    "mult_only": (4, 1, 0, 11, None),
    "hot_bucket": (8, 4, 300, 200, (150, 7, 9)),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_fused_layer_matches_host_engine(name):
    k, kc, na, nm, hot = LAYERS[name]
    rng = np.random.default_rng(len(name))
    n = 1 << k
    w = rand_field(rng, n)
    if name != "toy":
        w[::3] = [0] * len(w[::3])             # structural-length rules
    ag = random_gates(rng, na, 1 << kc, n, hot)
    mg = random_gates(rng, nm, 1 << kc, n, hot)
    z = rand_field(rng, kc)
    want = jax_layer_sumcheck(z, w, ag, mg, kc, k, jax_mle_struct(w), JaxMimc7())
    K.reset_launches()
    got = F.prove_layer_sumcheck_fused(z, w, ag, mg, kc, k, mle_struct(w),
                                       Mimc7(), device="cpu")
    assert no_launches()
    assert got == want


def test_fused_layer_takes_z_on_the_device():
    """z given as (k_cur, 16) device limbs (`z_dev`) stands for the host
    list z: the engine reads only the limbs."""
    rng = np.random.default_rng(75)
    k, kc = 4, 3
    w = rand_field(rng, 1 << k)
    ag = random_gates(rng, 10, 1 << kc, 1 << k)
    mg = random_gates(rng, 7, 1 << kc, 1 << k)
    z = rand_field(rng, kc)
    want = jax_layer_sumcheck(z, w, ag, mg, kc, k, jax_mle_struct(w), JaxMimc7())
    got = F.prove_layer_sumcheck_fused([], w, ag, mg, kc, k, mle_struct(w),
                                       Mimc7(), z_dev=L.pack(z).reshape(kc, 16),
                                       device="cpu")
    assert got == want


def test_finish_raises_on_a_corrupted_device_challenge():
    rng = np.random.default_rng(70)
    k, kc = 3, 2
    w = rand_field(rng, 1 << k)
    ag = random_gates(rng, 6, 1 << kc, 1 << k)
    mg = random_gates(rng, 5, 1 << kc, 1 << k)
    z = rand_field(rng, kc)
    args = (z, w, ag, mg, kc, k, mle_struct(w))
    arrays, finish = F.prove_layer_sumcheck_fused(*args, Mimc7(), defer=True,
                                                  device="cpu")
    co1, co2, rs1, rs2 = arrays
    assert co1.shape == (k, 3, 16) and rs2.shape == (k, 16)
    assert finish(F.download(arrays)) == jax_layer_sumcheck(
        z, w, ag, mg, kc, k, jax_mle_struct(w), JaxMimc7())
    rs2[1, 0] ^= 1
    with pytest.raises(RuntimeError, match="divergence at round 5"):
        finish(F.download(arrays))
    with pytest.raises(ValueError, match="MiMC7-91"):
        F.prove_layer_sumcheck_fused(*args, Mimc7(n_rounds=90), device="cpu")


# --------------------------------------------------------------- full prove

@pytest.mark.parametrize("case", ["toy", "seed5"])
def test_fused_prove_matches_host_backend(case):
    if case == "toy":
        c, inputs = reference_toy_circuit()
    else:
        c, inputs = random_circuit(random.Random(5), depth=3, max_k=3)
    want = gkr_tpu.prove(c, c.evaluate(inputs))
    pc = circuit_from(c)
    backend = port.TorchBackend(device="cpu", host_threshold=0)
    assert backend.fused
    K.reset_launches()
    got = port.prove(pc, pc.evaluate(inputs), backend=backend)
    assert no_launches()
    assert_proofs_identical(got, want)
    assert port.verify(got, pc, raise_on_fail=True)
    # a second proof of the same circuit reuses every layer's wiring plan
    plans = {i: ent[3] for i, ent in backend._wiring.items()}
    assert port.prove(pc, pc.evaluate(inputs), backend=backend) == got
    assert all(backend._wiring[i][3] is p for i, p in plans.items())


def test_wiring_cache_keys_on_gate_list_identity():
    b = port.TorchBackend(device="cpu")
    ag, mg = [(0, 1, 2), (1, 3, 0)], [(0, 2, 2)]
    first = b.wiring(1, ag, mg, 4)
    assert b.wiring(1, ag, mg, 4) is first
    assert b.wiring(1, list(ag), mg, 4) is not first      # another list object
    ag.append((1, 0, 0))
    assert b.wiring(1, ag, mg, 4).a1.out.numel() == 3      # length changed
    b.reset_cache()
    assert b.wiring(1, ag, mg, 4).a1.out.numel() == 3
