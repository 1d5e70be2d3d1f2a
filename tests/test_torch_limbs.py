"""The port's limb arithmetic and the plain versions of its four kernels,
against the JAX package (gkr_tpu.jaxeng) and host ints, on the CPU.

Inputs come from numpy seeds and reach both packages as the same limbs
(gkr_tpu_torch.convert).  Field arithmetic has no rounding: every check is
exact equality of canonical limbs or integers."""

import itertools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gkr_tpu.field import P, R
from gkr_tpu.jaxeng import limbs as JL
from gkr_tpu.jaxeng import sumcheck as JS
from gkr_tpu.mle import eq_table

from gkr_tpu_torch.convert import limbs_from_numpy, limbs_to_numpy
from gkr_tpu_torch.torcheng import kernels as K
from gkr_tpu_torch.torcheng import limbs as L

ROOT = Path(__file__).resolve().parent.parent
EDGE = [0, 1, 2, P - 1, P - 2, P // 2, (P + 1) // 2, R % P, (1 << 253) - 1,
        P - (1 << 16)]


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


def both(values):
    """The same Montgomery limbs as a JAX array and a port tensor."""
    j = JL.pack(values)
    return j, limbs_from_numpy(np.asarray(j))


def same(t, j):
    return np.array_equal(limbs_to_numpy(t), np.asarray(j))


@pytest.mark.parametrize("n", [1, 37, 1 << 12])
def test_pack_unpack_matches_jax(n):
    """n = 2^12 takes the bytes -> device -> x R^2 path in both packages."""
    vals = rand_field(np.random.default_rng(n), n)
    vals[:len(EDGE)] = EDGE[:n]
    j, _ = both(vals)
    t = L.pack(vals)
    assert t.dtype == torch.int32 and t.shape == (n, 16)
    assert same(t, j)
    assert L.unpack(t) == vals
    assert L.unpack_scalar(L.pack_scalar(vals[-1])) == vals[-1]


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_elementwise_ops_match_jax_and_host(op):
    rng = np.random.default_rng(1)
    pairs = list(itertools.product(EDGE, EDGE))
    xs = [a for a, _ in pairs] + rand_field(rng, 28)
    ys = [b for _, b in pairs] + rand_field(rng, 28)
    (jx, tx), (jy, ty) = both(xs), both(ys)
    port = {"add": L.add_mod, "sub": L.sub_mod, "mul": K.mont_mul}[op]
    jax_fn = {"add": JL.jadd, "sub": JL.jsub, "mul": JL.jmul}[op]
    host = {"add": lambda a, b: (a + b) % P, "sub": lambda a, b: (a - b) % P,
            "mul": lambda a, b: a * b % P}[op]
    got = port(tx, ty)
    assert same(got, jax_fn(jx, jy))
    assert L.unpack(got) == [host(a, b) for a, b in zip(xs, ys)]


def test_mont_mul_broadcast_rows():
    """b rows serve runs of a's rows: one scalar, or one row per point."""
    rng = np.random.default_rng(2)
    xs = rand_field(rng, 12)
    s = rand_field(rng, 3)
    a = L.pack(xs)
    assert L.unpack(L.mul_scalar(a, L.pack_scalar(s[0]))) == \
        [x * s[0] % P for x in xs]
    got = K.mont_mul(a.reshape(3, 4, 16), L.pack(s))
    assert L.unpack(got) == [x * s[i // 4] % P for i, x in enumerate(xs)]
    with pytest.raises(ValueError):
        K.mont_mul(a, L.pack(s[:2] + s[:3]))          # 5 rows do not divide 12


def test_normalize_relaxed_and_sum_mod():
    rng = np.random.default_rng(3)
    # relaxed sums of 1000 canonical rows: limbs < 2^26, value < 1000 p
    parts = [rand_field(rng, 8) for _ in range(1000)]
    stack = np.stack([np.asarray(JL.pack(p)) for p in parts])    # (1000, 8, 16)
    relaxed = stack.sum(axis=0, dtype=np.uint32)
    got = L.normalize_relaxed(torch.from_numpy(relaxed.astype(np.int64)))
    assert same(got, JL.jnormalize(jnp.asarray(relaxed)))
    for n in (1, 100, 5000):
        vals = rand_field(rng, n)
        t = L.pack(vals)
        assert L.unpack_scalar(L.sum_mod(t)) == sum(vals) % P
        if n <= 100:
            assert same(L.sum_mod(t), JL.jsum(JL.pack(vals)))


@pytest.mark.parametrize("tables", [4, 3])
def test_fold_plain_matches_jfold(tables):
    rng = np.random.default_rng(4 + tables)
    n = 16
    vals = rand_field(rng, n * tables)
    vals[:len(EDGE)] = EDGE
    js, ts = both(vals)
    js, ts = js.reshape(n, tables, 16), ts.reshape(n, tables, 16)
    for r in (rand_field(rng, 1)[0], 0, 1, P - 1):
        jr, tr = both([r])
        want = JL.jfold(js, jr[0])
        assert same(K.fold(ts, tr[0]), want)
        assert same(K.fold_plain(ts, tr[0]), want)
    assert K.LAUNCHES["fold"] == 0


def test_phase1_eval_plain_matches_jax():
    rng = np.random.default_rng(6)
    vals = rand_field(rng, 32 * 4)
    vals[:len(EDGE)] = EDGE
    js, ts = both(vals)
    js, ts = js.reshape(32, 4, 16), ts.reshape(32, 4, 16)
    want = JS._phase1_eval(js)
    assert same(K.phase1_eval(ts), want)
    assert same(K.phase1_eval_plain(ts), want)


@pytest.mark.parametrize("wb", [None, 0, P - 1])
def test_phase2_eval_plain_matches_jax(wb):
    rng = np.random.default_rng(7)
    vals = rand_field(rng, 32 * 3)
    vals[-len(EDGE):] = EDGE
    js, ts = both(vals)
    js, ts = js.reshape(32, 3, 16), ts.reshape(32, 3, 16)
    jw, tw = both([rand_field(rng, 1)[0] if wb is None else wb])
    want = JS._phase2_eval(js, jw[0])
    assert same(K.phase2_eval(ts, tw[0]), want)
    assert same(K.phase2_eval_plain(ts, tw[0]), want)


def _sum_mod_per_point(x):
    return K._normalize_rows_plain(x.sum(dim=0, dtype=torch.int64))


@pytest.mark.parametrize("n", [4, 64, 1 << 12])
def test_eval_plain_matches_its_per_point_form(n):
    """`phase*_eval_plain` and `round_coeffs_plain` take the three points
    t = 0, 1, 2 in one pass and normalise the three sums at once: bit-equal
    to the same arithmetic one point at a time (their form before the
    sharded engine), edge values included."""
    rng = np.random.default_rng(60 + n)
    v1, v2 = rand_field(rng, 4 * n), rand_field(rng, 3 * n)
    v1[:len(EDGE)], v2[-len(EDGE):] = EDGE, EDGE
    S1, S2 = L.pack(v1).reshape(n, 4, 16), L.pack(v2).reshape(n, 3, 16)
    want1 = torch.stack([_sum_mod_per_point(L.add_mod(K.mont_mul_plain(
        L.add_mod(X[:, 1], X[:, 3]), X[:, 0]), X[:, 2])) for X in L.eval3_halves(S1)])
    assert torch.equal(K.phase1_eval_plain(S1), want1)
    for wb_int in (rand_field(rng, 1)[0], 0, P - 1):
        wb = L.pack_scalar(wb_int, "cpu")
        want2 = torch.stack([_sum_mod_per_point(L.add_mod(
            K.mont_mul_plain(X[:, 1], L.add_mod(wb, X[:, 0])),
            K.mont_mul_plain(X[:, 2], X[:, 0]))) for X in L.eval3_halves(S2)])
        assert torch.equal(K.phase2_eval_plain(S2, wb), want2)
    part = L.pack(rand_field(rng, 3 * n // 2) + [P - 1] * (3 * n // 2)).reshape(n, 3, 16)
    y0, y1, y2 = (_sum_mod_per_point(part[:, t]) for t in range(3))
    c2 = K.mont_mul_plain(L.sub_mod(L.add_mod(y2, y0), L.add_mod(y1, y1)),
                          L.const("INV2_LIMBS", "cpu"))
    want = torch.stack([c2, L.sub_mod(L.sub_mod(y1, y0), c2), y0])
    assert torch.equal(K.round_coeffs_plain(part), want)


def test_eq_table_device_matches_jax_and_host():
    """The eq_table kernel's plain version (both engines' eq tables) against
    the JAX limb engine and the host table, edge coordinates included."""
    z = rand_field(np.random.default_rng(8), 5)
    z[1], z[3] = 0, P - 1
    jz, tz = both(z)
    got = K.eq_table(tz)
    assert same(got, JL.jeq_table(jz))
    assert L.unpack(got) == eq_table(z)
    assert L.unpack(K.eq_table(tz[:0])) == [1]


def eq_table_split_model(z: torch.Tensor, bits: int) -> torch.Tensor:
    """The eq kernel's split (csrc/kernels.cu k_eq_table) in plain
    products: the k variables cut MSB-first into factor tables of at most
    `bits` variables (T_0 takes the rest at the top), each entry the product
    of its factors; the value of row r = b >> kl (kl the last table's
    variables) the product of the upper tables' entries; entry b that value
    times the last table's entry b & (2^kl - 1)."""
    k = z.shape[0]
    one = L.const("MONT_ONE_LIMBS", z.device)
    if k == 0:
        return one.reshape(1, 16).clone()
    n = -(-k // bits)
    w0 = k - bits * (n - 1)
    kl = k if n == 1 else bits
    tables = []
    for t in range(n):
        w, v = (w0, 0) if t == 0 else (bits, w0 + bits * (t - 1))
        i = torch.arange(1 << w)
        x = None
        for q in range(w):
            bit = ((i >> (w - 1 - q)) & 1).bool()[:, None]
            zq = z[v + q].expand(1 << w, 16)
            f = torch.where(bit, zq, L.sub_mod(one, z[v + q]).expand(1 << w, 16))
            x = f.contiguous() if x is None else K.mont_mul_plain(x, f.contiguous())
        tables.append(x)
    r = torch.arange(1 << (k - kl))
    if n == 1:
        rows = one.reshape(1, 16)
    else:
        rows = tables[0][r >> (bits * (n - 2))]
        for t in range(1, n - 1):
            rows = K.mont_mul_plain(rows, tables[t][(r >> (bits * (n - 2 - t)))
                                                    & ((1 << bits) - 1)])
    return K.mont_mul_plain(rows.repeat_interleave(1 << kl, dim=0),
                            tables[-1].repeat(r.numel(), 1))


@pytest.mark.parametrize("k", range(13))
def test_eq_table_split_model_matches_plain_jax_and_host(k):
    """The eq kernel's split at every table width (the kernel's EQ_BITS
    among them), against the doubling (eq_table_plain, the wrapper's CPU
    path), the host table, and, at k = 5 and 6 (one and two of the kernel's
    tables), the JAX limb engine's jeq_table: this pins the MSB-first index
    order of the split on the CPU.  jeq_table's XLA:CPU compile grows with k
    (some 25 s alone at k = 12), so the larger k are held to the host."""
    z = rand_field(np.random.default_rng(50 + k), k)
    if k > 2:
        z[1], z[-1] = 0, P - 1
    jz, tz = both(z)
    want = K.eq_table_plain(tz)
    assert L.unpack(want) == eq_table(z)
    assert torch.equal(K.eq_table(tz), want)
    for bits in range(1, max(k, K.EQ_BITS) + 1):
        assert torch.equal(eq_table_split_model(tz, bits), want), bits
    if k in (5, 6):
        assert same(want, JL.jeq_table(jz))


def test_eq_table_refuses_a_point_beyond_its_limit():
    z = L.pack([3] * (K.EQ_MAX_K + 1))
    with pytest.raises(ValueError):
        K.eq_table(z)


def test_fr_cuh_constants():
    """Every constant of the CUDA field header against field.P."""
    src = (ROOT / "gkr_tpu_torch" / "csrc" / "fr.cuh").read_text()
    body = re.search(r"FR_P\[8\]\s*=\s*\{([^}]*)\}", src).group(1)
    words = [int(w, 16) for w in re.findall(r"0x([0-9a-fA-F]+)u", body)]
    assert len(words) == 8
    assert sum(w << (32 * i) for i, w in enumerate(words)) == P
    nprime = int(re.search(r"#define FR_NPRIME32 0x([0-9a-fA-F]+)u", src).group(1), 16)
    assert nprime == (-pow(P, -1, 1 << 32)) % (1 << 32)
    assert (P * nprime + 1) % (1 << 32) == 0
    decimal = re.search(r"// p = (\d+)", src).group(1)
    assert int(decimal) == P
    assert P.bit_length() == 254      # fr_add and fr_mul rely on p < 2^254


def test_convert_roundtrip_and_checks():
    a = np.asarray(JL.pack(rand_field(np.random.default_rng(9), 5)))
    t = limbs_from_numpy(a)
    assert t.dtype == torch.int32
    assert np.array_equal(limbs_to_numpy(t), a)
    with pytest.raises(ValueError):
        limbs_from_numpy(np.full((2, 16), 1 << 16, dtype=np.uint32))


def test_wrappers_take_plain_versions_on_cpu():
    """CPU tensors run the plain versions: nothing launches, nothing builds;
    wrong limb types are refused."""
    K.reset_launches()
    S = L.pack(rand_field(np.random.default_rng(10), 8 * 4)).reshape(8, 4, 16)
    S3 = S[:, :3].contiguous()
    K.phase1_eval(S)
    K.phase2_eval(S3, S[0, 0])
    K.fold(S, S[0, 0])
    K.mont_mul(S, S)
    K.round_tail(K.phase1_partials(S), 3)
    K.round_tail(K.phase2_partials(S3, S[0, 0]), 2)
    K.mimc_multi(S[0, :3])
    rel = K.seg_sum([S[:, 0], S[:, 1]], torch.tensor([2, 2, 5, 8], dtype=torch.int32))
    K.normalize(rel[0])
    K.normalize(rel[1], S[0, 0])
    K.eq_table(S[:2, 0])
    K.stack([S[:, 0], None, S[:, 2]])
    words = S[:, :, 0].contiguous()
    K.u32_mul_chain(words, words, 16)
    K.micro_op("u32_mul", words, words)
    K.micro_op("f32_fma", words.float(), words.float())
    for variant in K.MONT_VARIANTS:
        K.mont_chain(S[:, 0], S[:, 1], 1, variant)
    assert set(K.LAUNCHES) == {
        "mont_mul", "fold", "phase1_eval", "phase2_eval", "phase1_partials",
        "phase2_partials", "round_tail", "mimc_multi", "eq_table",
        "seg_sum", "normalize", "normalize_mul", "stack", "u32_mul_chain",
        "micro_op", *(f"mont_chain_{v}" for v in K.MONT_VARIANTS)}
    assert not any(K.LAUNCHES.values())
    assert K._lib is None
    with pytest.raises(ValueError):
        K.mont_mul(S.to(torch.int64), S.to(torch.int64))
    with pytest.raises(ValueError):
        K.phase1_eval(S[:, :3])
