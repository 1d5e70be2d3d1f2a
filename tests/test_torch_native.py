"""The port's native host engine (gkr_tpu_torch.native: csrc/gkrhost.cpp,
the loader, CppBackend, NativeMimc7, sparse_from_dense_native) and
mimc.fast_transcript, against the JAX package on the CPU.

The library's entry points are held to gkr_tpu's field and mle on seeded
values with 0, 1 and p - 1; proofs and challenges must be identical to
gkr_tpu's host engine and to gkr_tpu's own CppBackend.  The C++ engine's
OpenMP threads follow torch's setting in this process (one runtime), held
at 2 here so the parallel reductions run while the suite's other workers
keep their cores."""

import json
import random
import sys
import threading

import pytest
import torch

import gkr_tpu
import gkr_tpu.mimc as jax_mimc
from gkr_tpu import mle as jax_mle
from gkr_tpu.native import lib as jax_native_lib
from gkr_tpu.native.engine import CppBackend as JaxCppBackend
from gkr_tpu.sumcheck import prove_layer_sumcheck as jax_layer_sumcheck

import gkr_tpu_torch as port
from gkr_tpu_torch import bench as B
from gkr_tpu_torch import mimc as port_mimc
from gkr_tpu_torch import native
from gkr_tpu_torch.convert import circuit_from
from gkr_tpu_torch.field import P
from gkr_tpu_torch.native import engine as E

from test_gkr_e2e import random_circuit, reference_toy_circuit

EDGES = [0, 1, 2, P - 2, P - 1]


@pytest.fixture(autouse=True, scope="module")
def libraries():
    """Both packages' libraries, built side by side (one compiler each)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    ref = threading.Thread(target=jax_native_lib)
    ref.start()
    native.lib()
    ref.join()
    assert jax_native_lib() is not None, "gkr_tpu's libgkrhost did not load"
    yield
    torch.set_num_threads(threads)


def values(seed: int, n: int) -> list[int]:
    rng = random.Random(seed)
    return EDGES + [rng.randrange(P) for _ in range(n - len(EDGES))]


def as_json(proof) -> str:
    return json.dumps(proof.to_dict())


# ------------------------------------------------------------ the library

@pytest.mark.parametrize("op", ["mul", "add", "mont", "eq_table", "mobius"])
def test_library_entry_points_match_gkr_tpu(op):
    L, buf = native.lib(), E._buf
    xs, ys = values(1, 2048), values(2, 2048)[::-1]
    a, b = E.ints_to_buf(xs), E.ints_to_buf(ys)
    out = bytearray(len(a))
    if op == "mul":
        L.gkr_batch_mul(buf(a), buf(b), buf(out), len(xs))
        assert E.buf_to_ints(out) == [x * y % P for x, y in zip(xs, ys)]
    elif op == "add":
        L.gkr_batch_add(buf(a), buf(b), buf(out), len(xs))
        assert E.buf_to_ints(out) == [(x + y) % P for x, y in zip(xs, ys)]
    elif op == "mont":
        L.gkr_to_mont(buf(a), len(xs))
        assert E.buf_to_ints(a) == [x * 2 ** 256 % P for x in xs]
        L.gkr_from_mont(buf(a), len(xs))
        assert E.buf_to_ints(a) == xs
    elif op == "eq_table":
        for point in ([], EDGES[:3], values(3, 11)):
            z = E.ints_to_buf(point)
            if point:
                L.gkr_to_mont(buf(z), len(point))
            table = bytearray(32 << len(point))
            L.gkr_eq_table(buf(z) if point else None, len(point), buf(table))
            L.gkr_from_mont(buf(table), 1 << len(point))
            assert E.buf_to_ints(table) == jax_mle.eq_table(point)
    else:
        L.gkr_mobius(buf(a), len(xs))
        assert E.buf_to_ints(a) == jax_mle.mobius(xs)


@pytest.mark.parametrize("key", [0, 12345])
def test_native_mimc_matches_gkr_tpu(key):
    m_c, m_py = E.NativeMimc7(), gkr_tpu.Mimc7()
    rng = random.Random(4)
    for n in (1, 2, 3, 5):
        arr = [rng.choice(EDGES + [rng.randrange(P)]) for _ in range(n)]
        assert m_c.multi_hash(arr, key) == m_py.multi_hash(arr, key)


def test_fast_transcript_swaps_only_a_plain_91_round_mimc7():
    """An exact Mimc7() takes the native hash; a subclass and a 5-round
    Mimc7 keep their own.  The reference swaps a 5-round Mimc7 too, and
    then hashes with 91 rounds."""
    class Forged(port_mimc.Mimc7):
        pass

    assert isinstance(port_mimc.fast_transcript(port_mimc.Mimc7()), E.NativeMimc7)
    for t in (Forged(), port_mimc.Mimc7(n_rounds=5)):
        assert port_mimc.fast_transcript(t) is t
    arr = [3, P - 1]
    five = gkr_tpu.Mimc7(n_rounds=5).multi_hash(arr, 0)
    assert port_mimc.Mimc7(n_rounds=5).multi_hash(arr, 0) == five
    assert jax_mimc.fast_transcript(gkr_tpu.Mimc7(n_rounds=5)).multi_hash(arr, 0) != five


# ---------------------------------------------------------------- proofs

def _case(case):
    if case == "toy":
        return reference_toy_circuit()
    rng = random.Random(int(case[4:]))
    return random_circuit(rng, depth=rng.randrange(1, 4))


@pytest.mark.parametrize("case", ["toy", "seed0", "seed3", "seed11"])
def test_cpp_backend_proofs_match_gkr_tpu(case):
    """The port's CppBackend against gkr_tpu's host engine and its
    CppBackend: identical proofs, accepted by both verifiers."""
    c, inputs = _case(case)
    w = c.evaluate(inputs)
    host = gkr_tpu.prove(c, w)
    ref_cpp = gkr_tpu.prove(c, w, backend=JaxCppBackend())
    pc = circuit_from(c)
    got = port.prove(pc, pc.evaluate(inputs), backend=E.CppBackend())
    assert as_json(got) == as_json(host) == as_json(ref_cpp)
    assert port.verify(got, pc, raise_on_fail=True)
    assert gkr_tpu.verify(gkr_tpu.proof.Proof.from_dict(got.to_dict()), c)


def test_cpp_layer_sumcheck_at_2e12_matches_gkr_tpu():
    """A device-sized shape: the bench's 2^12 layer (2^12 gates over 16
    outputs, full support), against gkr_tpu's host engine."""
    z, w, ag, mg, kc, struct = B.synth_layer(random.Random(1), 12)
    want = jax_layer_sumcheck(z, w, ag, mg, kc, 12,
                              jax_mle.MleStruct(12, False, [True] * 12, 12),
                              gkr_tpu.Mimc7())
    got = E.CppBackend().layer_sumcheck(z, w, ag, mg, kc, 12, struct,
                                        port_mimc.Mimc7())
    assert got == want


@pytest.mark.parametrize("k", [0, 1, 10])
def test_sparse_from_dense_native_matches_host_transform(k):
    table = values(5, max(1 << k, len(EDGES)))[:1 << k]
    if k > 1:
        table[len(table) // 2:] = [0] * (len(table) // 2)  # terms that vanish
    got = E.sparse_from_dense_native(table)
    assert list(got) == jax_mle.sparse_from_dense(table)


def test_a_shared_cpp_backend_proves_in_this_process(monkeypatch):
    """prove_subcircuits keeps one shared CppBackend (--backend cpp
    --workers 1) in this process; only a plain HostBackend takes the spawn
    pool, whose children prove with the Python engine."""
    from gkr_tpu_torch.recursion import aggregator as A
    calls = []

    class Counting(E.CppBackend):
        def layer_sumcheck(self, *a, **kw):
            calls.append(1)
            return super().layer_sumcheck(*a, **kw)

    monkeypatch.setattr(A, "PROCESS_MIN_GATES", 0)
    c, inputs = reference_toy_circuit()
    pc = circuit_from(c)
    w = pc.evaluate(inputs)
    proofs = A.prove_subcircuits([pc, pc], [w, w], backend=Counting(), max_workers=1)
    assert len(calls) == 2 * pc.depth()
    assert as_json(proofs[1]) == as_json(gkr_tpu.prove(c, c.evaluate(inputs)))


# --------------------------------------------------------------- loader

def _stub_compiler(tmp_path, body: str) -> str:
    script = tmp_path / "cxx"
    script.write_text("#!/bin/sh\n" + body)
    script.chmod(0o755)
    return str(script)


def test_the_build_runs_once_under_concurrent_callers(tmp_path, monkeypatch):
    """build() holds a file lock and renames the finished file into place:
    however many callers reach it at once, the compiler runs once."""
    log = tmp_path / "calls"
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "CXX", _stub_compiler(
        tmp_path, f'echo run >> {log}\nsleep 0.2\nfor last; do :; done\n'
                  'echo built > "$last"\n'))
    outs = []
    threads = [threading.Thread(target=lambda: outs.append(native.build()))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert log.read_text().splitlines() == ["run"]
    assert set(outs) == {native.library_path()}
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == \
        sorted(["gkrhost.lock", native.library_path().name])


def test_library_loads_once_under_threads(monkeypatch):
    loads = []

    def load_library():
        loads.append(1)
        return object()

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_library", load_library)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=native.lib) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert len(loads) == 1 and native._lib is not None


@pytest.mark.parametrize("how", ["failed build", "GKR_NO_NATIVE=1"])
def test_no_quiet_fallback(tmp_path, monkeypatch, how):
    """A compiler that fails makes every native path raise with its report;
    only GKR_NO_NATIVE=1 gives the Python hash, and CppBackend() raises."""
    monkeypatch.setattr(native, "_lib", None)
    plain = port_mimc.Mimc7()
    if how == "failed build":
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(native, "CXX", _stub_compiler(
            tmp_path, 'echo "gkrhost.cpp:1: error: stub failure" >&2\nexit 1\n'))
        for call in (native.lib, E.CppBackend, E.NativeMimc7,
                     lambda: port_mimc.fast_transcript(plain),
                     lambda: port.verify(port.prove(*_toy_host()))):
            with pytest.raises(RuntimeError, match="stub failure"):
                call()
        assert [p.name for p in (tmp_path / "build").iterdir()] == ["gkrhost.lock"]
    else:
        monkeypatch.setenv("GKR_NO_NATIVE", "1")
        assert native.lib() is None
        assert port_mimc.fast_transcript(plain) is plain
        for call in (E.CppBackend, E.NativeMimc7,
                     lambda: E.sparse_from_dense_native([1, 2])):
            with pytest.raises(RuntimeError, match="GKR_NO_NATIVE"):
                call()
        proof = port.prove(*_toy_host())
        assert port.verify(proof)


def _toy_host():
    c, inputs = reference_toy_circuit()
    pc = circuit_from(c)
    return pc, pc.evaluate(inputs), None, None, port.HostBackend()
