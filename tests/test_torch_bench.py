"""The port bench (gkr_tpu_torch.bench) and the plain versions of its probe
kernels, on the CPU.

The bench's generators and work accounting are held to the JAX package's
bench.py (importing it is cheap: its module level imports no JAX); the
probes' plain versions to numpy's uint32/int32/float32 arithmetic and to the
JAX kernels' bodies run eagerly through jnp, and the Montgomery chain to host
integers.  Integer results are compared exactly.  The f32 ops are exact here
too: on the CPU the plain versions, numpy and jnp round each multiply and
each add once, in the same order (on the card the kernel's f32_fma rounds
once a step, so chip_smoke.py compares it with a relative tolerance)."""

import inspect
import json
import random
from collections import Counter
import runpy
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench

from gkr_tpu_torch import bench as B
from gkr_tpu_torch import probes
from gkr_tpu_torch.field import P, R
from gkr_tpu_torch.torcheng import kernels as K
from gkr_tpu_torch.torcheng import limbs as L

SHAPE = (16, 1024)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs its files in parallel workers; torch's intra-op threads
    buy these small tensors nothing and take cores from the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------- generators

def test_synth_layer_matches_bench_py():
    got = B.synth_layer(random.Random(1), 6)
    want = jax_bench.synth_layer(random.Random(1), 6)
    assert got[:5] == want[:5]
    assert (got[5].k, got[5].empty, got[5].support, got[5].maxdeg) == \
        (want[5].k, want[5].empty, want[5].support, want[5].maxdeg)


def test_synth_circuit_matches_bench_py():
    got = B.synth_circuit(random.Random(7), 6, 4)
    want = jax_bench.synth_circuit(random.Random(7), 6, 4)
    assert got.input_k == want.input_k
    assert [(l.k_cur, l.k_next, l.add_gates, l.mult_gates) for l in got.layers] == \
        [(l.k_cur, l.k_next, l.add_gates, l.mult_gates) for l in want.layers]


def _bench_py_work(n):
    """bench.py main()'s own accounting block, run as it stands there."""
    src = inspect.getsource(jax_bench.main)
    start = src.rindex("\n", 0, src.index("entries = 0")) + 1
    block = src[start:src.index("# hardware roofline")]
    ns = {"n": n}
    exec(textwrap.dedent(block), ns)
    return ns["entries"], ns["mont_muls"]


@pytest.mark.parametrize("k", [1, 8, 20, 24])
def test_work_and_hbm_model_match_bench_py(k):
    n = 1 << k
    assert B.work(n) == _bench_py_work(n)
    for na, nm in ((n // 2, n // 2), (n, 0), (3, 5)):
        assert B._min_hbm_bytes(n, na, nm) == jax_bench._min_hbm_bytes(n, na, nm)


# -------------------------------------------------------------------- runs

def test_run_device_on_the_cpu():
    K.reset_launches()
    dt, b1, b2 = B.run_device(8, device="cpu", reps=1)
    assert dt > 0 and b1 > 0 and b2 > 0
    assert not any(K.LAUNCHES.values())


def test_bench_without_a_card_exits_nonzero(monkeypatch, capsys):
    """`python -m gkr_tpu_torch.bench` without a card raises (so the command
    exits non-zero) before it prints a metric line.  Run in this process
    as `python -m` runs it (runpy), without the cost of a new interpreter."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delitem(sys.modules, "gkr_tpu_torch.bench")   # run it afresh
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runpy.run_module("gkr_tpu_torch.bench", run_name="__main__")
    assert '"metric"' not in capsys.readouterr().out


@pytest.mark.parametrize("cell", ["raises", "ends"])
def test_extras_are_printed_before_the_aggregation_cell(monkeypatch, capsys, cell):
    """GKR_BENCH_EXTRA=1: the line with layer_2e16, full_prove and layer_2e24
    is out before the aggregation cell starts, so a cell that raises (or never
    ends) loses none of them; a cell that ends adds a second line with the
    cell under extra.aggregation_e2e.  Every measurement is stubbed."""
    monkeypatch.setenv("GKR_BENCH_EXTRA", "1")
    monkeypatch.setattr(B.probes, "require_card", lambda: None)
    monkeypatch.setattr(B, "run_device", lambda k, breakdown=True: (1e-3 * k, 1e-4, 1e-4))
    monkeypatch.setattr(B, "run_kernel_peak", lambda: 1e9)
    monkeypatch.setattr(B, "run_host", lambda k: 1e3)
    monkeypatch.setattr(B, "run_cpp", lambda k: 1e4)
    monkeypatch.setattr(B, "roofline", lambda dt, n, muls: (None, "stubbed"))
    monkeypatch.setattr(B, "sync_rtt_s", lambda: 1e-5)
    monkeypatch.setattr(B, "run_device_pipelined", lambda k: (1e6, 1e-2))
    monkeypatch.setattr(B, "run_full_prove",
                        lambda k, kin: (3 << k, 2.0, {"prove": 1.0}, 3.0, 1.5))
    monkeypatch.setattr(B, "card_label", lambda: "stub card")
    printed_before = []

    def aggregation(log=None):
        printed_before.append(capsys.readouterr().out)
        if cell == "raises":
            raise RuntimeError("the cell failed")
        return {"total_s": 9.0}

    monkeypatch.setattr(B, "run_aggregation", aggregation)
    if cell == "raises":
        with pytest.raises(RuntimeError, match="the cell failed"):
            B.main()
    else:
        B.main()
    first = printed_before[0].splitlines()
    assert len(first) == 1
    extra = json.loads(first[0])["extra"]
    assert set(extra) == {"layer_2e16", "full_prove", f"layer_2e{B.TOP_K}"}
    rest = capsys.readouterr().out.splitlines()
    if cell == "raises":
        assert rest == []
    else:
        assert len(rest) == 1
        second = json.loads(rest[0])
        assert second["extra"] == {**extra, "aggregation_e2e": {"total_s": 9.0}}


def test_the_baseline_is_the_cpp_engine_at_the_headline_size(monkeypatch):
    """vs_baseline is value / cpp_gates_per_sec, the C++ engine measured on
    the same 2^20 layer (bench.py's `run_cpp`); the host Python engine stays
    as host_py_gates_per_sec.  The device is stubbed; run_cpp runs for real
    on a 2^8 layer."""
    assert B.run_cpp(8) > 0
    cpp_sizes = []

    def run_cpp(k):
        cpp_sizes.append(k)
        return 4.5e5

    monkeypatch.delenv("GKR_BENCH_EXTRA", raising=False)
    monkeypatch.setattr(B.probes, "require_card", lambda: None)
    monkeypatch.setattr(B, "run_device", lambda k, breakdown=True: (2e-2, 1e-3, 1e-3))
    monkeypatch.setattr(B, "run_kernel_peak", lambda: 1e9)
    monkeypatch.setattr(B, "run_host", lambda k: 1e3)
    monkeypatch.setattr(B, "run_cpp", run_cpp)
    monkeypatch.setattr(B, "roofline", lambda dt, n, muls: (None, "stubbed"))
    monkeypatch.setattr(B, "sync_rtt_s", lambda: 1e-5)
    monkeypatch.setattr(B, "run_device_pipelined", lambda k: (1e6, 1e-2))
    monkeypatch.setattr(B, "card_label", lambda: "stub card")
    out = B.main()
    assert cpp_sizes == [B.LAYER_K] == [20]
    assert out["cpp_measured_at"] == "2^20" and out["cpp_gates_per_sec"] == 4.5e5
    assert out["value"] == round((1 << 20) / 2e-2, 1)
    assert out["vs_baseline"] == round(out["value"] / 4.5e5, 2)
    assert out["baseline"].startswith("C++ host engine") and "2^20" in out["baseline"]
    assert out["host_py_gates_per_sec"] == 1e3


# ----------------------------------------------------------------- probes

def _words(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=SHAPE, dtype=np.uint32)


def _t(a):
    """numpy uint32 -> the int32 tensor of the same bits."""
    return torch.from_numpy(a.view(np.int32).copy())


def _u(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("reps", K.CHAIN_REPS)
def test_u32_mul_chain_plain_matches_numpy_and_jnp(reps):
    """The peak probe: 8 accumulators a + c, `reps` products by b, summed,
    mod 2^32 -- as numpy computes it and as bench.py's kernel body does."""
    a, b = _words(1), _words(2)
    got = _u(K.u32_mul_chain(_t(a), _t(b), reps))
    accs = [a + np.uint32(c) for c in range(K.CHAINS)]
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    jaccs = [ja + jnp.uint32(c) for c in range(K.CHAINS)]
    for _ in range(reps):
        accs = [acc * b for acc in accs]
        jaccs = [acc * jb for acc in jaccs]
    assert np.array_equal(got, np.sum(accs, axis=0, dtype=np.uint32))
    out = jaccs[0]
    for acc in jaccs[1:]:
        out = out + acc
    assert np.array_equal(got, np.asarray(out))


def _numpy_op(op, acc, a, b):
    if op == "u32_add":
        return acc + b
    if op in ("u32_mul", "i32_mul", "f32_mul"):
        return acc * b
    if op == "u32_mul16":
        return (acc & 0xFFFF) * (b & 0xFFFF)
    if op == "u32_shift":
        return (acc >> 16) + b
    return acc * b + a                                  # f32_fma


@pytest.mark.parametrize("op", K.MICRO_OPS)
def test_micro_op_plain_matches_numpy_and_jnp(op):
    """Each op of scripts/micro_vpu.py, 16 times and as often as the
    shallower deep run, on the operands it draws (and on full-range words
    for the integer ops).  jnp at 16 times only: XLA:CPU flushes subnormal
    floats to zero, which the deep run's products by b < 1 reach."""
    a_t, b_t = probes.micro_inputs(op, "cpu", shape=SHAPE)
    cases = [(a_t.numpy(), b_t.numpy())]
    if op.startswith("u32"):
        cases.append((_words(3), _words(4)))
    elif op == "i32_mul":
        cases.append((_words(3).view(np.int32), _words(4).view(np.int32)))
    for a, b in cases:
        for reps in K.MICRO_REPS[:2]:
            ta = _t(a) if a.dtype == np.uint32 else torch.from_numpy(a.copy())
            tb = _t(b) if b.dtype == np.uint32 else torch.from_numpy(b.copy())
            got = K.micro_op(op, ta, tb, reps).numpy()
            acc, jacc = a, jnp.asarray(a)
            ja, jb = jnp.asarray(a), jnp.asarray(b)
            with np.errstate(over="ignore"):
                for i in range(reps):
                    acc = _numpy_op(op, acc, a, b)
                    if i < K.MICRO_REPS[0]:
                        jacc = _numpy_op(op, jacc, ja, jb)
            assert np.array_equal(got.view(acc.dtype), acc)
            if reps == K.MICRO_REPS[0]:
                assert np.array_equal(got.view(acc.dtype), np.asarray(jacc))


def test_mont_chain_plain_matches_host_ints():
    """x = a, three times x = x * b / R: a * b^3 * R^-3 mod p, on edge
    values (0, 1, p - 1) and random ones."""
    rng = np.random.default_rng(5)
    edges = [0, 1, P - 1, P - 2, R % P]
    rand = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(11)]
    xs = edges + rand
    ys = [edges[(i + 2) % len(edges)] for i in range(len(edges))] + rand[::-1]
    a = torch.from_numpy(L.canonical_limbs(xs))
    b = torch.from_numpy(L.canonical_limbs(ys))
    r_inv = pow(R, P - 2, P)
    for depth in (1, 3, 9):
        got = L.unpack(K.mont_chain_plain(a, b, depth), montgomery=False)
        assert got == [x * pow(y * r_inv, depth, P) % P for x, y in zip(xs, ys)]
    K.reset_launches()
    for variant in K.MONT_VARIANTS:
        assert torch.equal(K.mont_chain(a, b, 9, variant, 1024), K.mont_chain_plain(a, b, 9))
    assert not any(K.LAUNCHES.values())


def test_probe_wrappers_refuse_what_their_kernels_do_not_take():
    a = torch.zeros(SHAPE, dtype=torch.int32)
    limbs = torch.zeros((4, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        K.u32_mul_chain(a, a, 17)
    with pytest.raises(ValueError):
        K.u32_mul_chain(a, a.to(torch.int64), 16)
    with pytest.raises(ValueError):
        K.micro_op("u32_div", a, a)
    with pytest.raises(ValueError):
        K.micro_op("f32_mul", a, a)                 # f32 ops take float32
    with pytest.raises(ValueError):
        K.micro_op("u32_add", a, a, 15)
    with pytest.raises(ValueError):
        K.mont_chain(limbs, limbs, 2)
    with pytest.raises(ValueError):
        K.mont_chain(limbs, limbs, 1, "karatsuba")
    with pytest.raises(ValueError):
        K.mont_chain(limbs, limbs, 1, block=96)
    for variant in ("f64", "cc"):
        with pytest.raises(ValueError):
            K.mont_chain(limbs, limbs, 2, variant)
        with pytest.raises(ValueError):
            K.mont_chain(limbs, limbs, 9, variant, 64)
        with pytest.raises(ValueError):
            K.mont_chain(limbs[:3], limbs, 1, variant)
    with pytest.raises(ValueError):
        K.mont_chain(limbs, limbs, 1, "f32")


def test_demangled_probe_names():
    assert probes._demangle("_Z12k_mont_chainILi0ELi9ELi256EEvPKjS1_Pjx") == \
        "k_mont_chain<0,9,256>"
    assert probes._demangle("_Z15k_u32_mul_chainILi128EEvPKjS1_Pjx") == \
        "k_u32_mul_chain<128>"
    assert probes._demangle("_Z10k_mont_mulPKjS0_Pjxx") == "k_mont_mul"


def test_sass_imads_leave_out_moves():
    c = Counter({"IMAD.WIDE.U32": 5, "IMAD.HI.U32": 2, "IMAD": 3, "IMAD.X": 1,
                 "IMAD.MOV.U32": 7, "IMAD.MOV": 2, "IADD3": 9, "LOP3.LUT": 4})
    assert probes.imads(c) == 11
    assert probes.wide_imads(c) == 5


def test_sass_counts_the_fp64_pipe_and_the_high_halves():
    c = Counter({"IMAD.WIDE.U32.X": 4, "IMAD.WIDE.U32": 1, "IMAD.HI.U32": 3,
                 "IMAD.HI": 1, "DFMA": 6, "DFMA.RZ": 5, "DADD": 7, "DMUL": 2,
                 "DSETP.GT.AND": 1, "IADD3": 9, "FFMA": 4})
    assert probes.wide_imads(c) == 5
    assert probes.hi_imads(c) == 4
    assert probes.dfmas(c) == 11
    assert probes.fp64_ops(c) == 20
    assert probes.imads(c) == 9


def synthetic_sass(per_variant: dict[str, Counter]) -> dict[str, Counter]:
    """The opcode counts sass_summary reads, with each Montgomery variant's
    product given: depth 1 holds the set-up and one product, depth 9 the
    same and eight more."""
    setup = Counter({"LDG.E.128": 8, "STG.E.128": 4, "IMAD.MOV.U32": 3, "EXIT": 1})
    counts = {"k_u32_mul_chain<16>": Counter({"IMAD": 16 * K.CHAINS, "IADD3": 8}),
              "k_u32_mul_chain<128>": Counter({"IMAD": 128 * K.CHAINS, "IADD3": 8})}
    d0, d1 = K.MONT_DEPTHS
    for v, name in enumerate(K.MONT_VARIANTS):
        for d in (d0, d1):
            c = Counter(setup)
            for op, x in per_variant[name].items():
                c[op] += d * x
            counts[f"k_mont_chain<{v},{d},256>"] = c
    for i in range(len(K.MICRO_OPS)):
        for r in K.MICRO_REPS:
            counts[f"k_micro_op<{i},{r}>"] = Counter({"IMAD": r, "EXIT": 1})
    return counts


def integer_product(imad: int, wide: int, hi: int, alu: int) -> Counter:
    return Counter({"IMAD": imad - wide - hi, "IMAD.WIDE.U32": wide,
                    "IMAD.HI.U32": hi, "IADD3": alu, "IMAD.MOV.U32": 5})


@pytest.mark.parametrize("dfma, dadd, f64_instr, lowered",
                         [(99, 60, 393, False), (80, 50, 260, True)])
def test_one_price_a_product_over_the_integer_variants(dfma, dadd, f64_instr, lowered):
    """imad_per_mont_mul is the least IMAD count of the integer variants
    (an FP64 variant's few IMADs do not count); the FP64 variant's floor is
    its busiest resource, max(IMAD slots, FP64 ops, instructions / 2); the
    shared price is lowered to that floor only where it is below."""
    fp64 = Counter({"IMAD": 25, "IMAD.WIDE.U32": 5, "DFMA": dfma - 40, "DFMA.RZ": 40,
                    "DADD": dadd, "IADD3": f64_instr - 30 - dfma - dadd})
    per = {"cios32": integer_product(232, 120, 8, 351),
           "school": integer_product(246, 120, 8, 368),
           "lat": integer_product(171, 162, 0, 242),
           "f64": fp64,
           "cc": integer_product(152, 119, 9, 165)}
    out = probes.sass_summary(synthetic_sass(per))
    assert out["peak_imad_per_rep"] == K.CHAINS
    assert out["imad_per_mont_mul_f64"] == 30
    assert out["wide_per_mont_mul_cc"] == 119 and out["hi_per_mont_mul_cc"] == 9
    assert out["dfma_per_mont_mul_f64"] == dfma
    assert out["fp64_per_mont_mul_f64"] == dfma + dadd
    assert out["instr_per_mont_mul_f64"] == f64_instr
    assert out["instr_per_mont_mul_cios32"] == 232 + 351 + 5
    assert out["imad_per_mont_mul"] == 152              # cc's, not f64's 30
    hi_extra = probes.IMAD_HI_PASSES - 1
    wide_extra = probes.IMAD_WIDE_PASSES - 1
    assert out["floor_per_mont_mul_cc"] == max(152 + 119 * wide_extra + 9 * hi_extra,
                                               (152 + 165 + 5) / 2)
    floor = max(30 + 5 * wide_extra, dfma + dadd, f64_instr / 2)
    assert out["floor_per_mont_mul_f64"] == floor
    assert out["price_per_mont_mul"] == (floor if lowered else 152)
    assert (out["price_per_mont_mul"] < out["imad_per_mont_mul"]) == lowered


def test_a_reading_faster_than_its_bound_raises():
    """chip_smoke.record's check: a kernel may not read faster than CEILING
    x its bound's rate."""
    probes.check_bound("eq_table", 0.0346, 0.0200)
    probes.check_bound("mont_chain_cc", 0.1, 0.1 * probes.CEILING)
    with pytest.raises(RuntimeError, match="the bound is wrong"):
        probes.check_bound("mont_chain_cc", 0.1, 0.1 * probes.CEILING * 1.001)
    import chip_smoke

    assert "check_bound(name, ms, b_ms)" in inspect.getsource(chip_smoke.phase_kernels)


def test_rate_above_the_ceiling_raises():
    peak = 16.7e12
    probes.check_ceiling("u32 multiply chain", peak, peak)
    probes.check_ceiling("u32 multiply chain", probes.CEILING * peak, peak)
    with pytest.raises(RuntimeError, match="folded chain"):
        probes.check_ceiling("u32 multiply chain", 1.03 * peak, peak)


def test_serial_floor_counts_the_rounds_hashes():
    """bench.py's layer has full support and both gate kinds: every one of
    its 2k rounds hashes 3 coefficients."""
    for k in (3, 8, 20):
        assert B.hashed_elements(k) == 3 * 2 * k
