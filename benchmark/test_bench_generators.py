"""The generators: deterministic from the seed, the shapes their sources
state, the matrix circuit's output A B, and the reference against the
program's exact host prover at small shapes."""

import numpy as np
import pytest

from benchmark.conftest import small_config
from benchmark.generators import matmul, synth
from benchmark.generators.common import P, evaluate, gate_tuples, rng
from benchmark.reference.compare import as_proof, proof_mismatches
from benchmark.reference.gkr import Reference

SEED = 2**31 + 77


def _same(a, b):
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and np.array_equal(a, b)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


@pytest.mark.parametrize("name", ["synth20", "matmul"])
def test_deterministic_from_the_seed(name):
    cfg = small_config(name)
    gen = synth if cfg["generator"] == "synth" else matmul
    c1, c2 = gen.circuit(cfg, rng(SEED, 0)), gen.circuit(cfg, rng(SEED, 0))
    assert _same(c1, c2)
    w1, w2 = gen.witness(c1, rng(SEED, 1)), gen.witness(c2, rng(SEED, 1))
    assert _same(w1, w2)
    assert not _same(w1, gen.witness(c1, rng(SEED + 1, 1)))
    if name == "synth20":
        assert _same(synth.layer(cfg, rng(SEED, 0)), synth.layer(cfg, rng(SEED, 0)))
        assert not _same(synth.layer(cfg, rng(SEED, 0))["add"],
                         synth.layer(cfg, rng(SEED + 1, 0))["add"])


def test_synth_shapes():
    cfg = dict(small_config("synth20"), k=6, k_input=4)
    circ = synth.circuit(cfg, rng(SEED, 0))
    (kc0, kn0, a0, m0), (kc1, kn1, a1, m1), (kc2, kn2, a2, m2) = circ["layers"]
    assert (kc0, kn0, kc1, kn1, kc2, kn2) == (4, 6, 6, 6, 6, 4)
    assert m0 is None and a0.shape == (3, 16) and a0[0].tolist() == list(range(16))
    for add, mult, fan_in in ((a1, m1, 64), (a2, m2, 16)):
        assert (add[0] % 2 == 1).all() and (mult[0] % 2 == 0).all()
        assert sorted(add[0].tolist() + mult[0].tolist()) == list(range(64))
        assert add[1:].max() < fan_in and mult[1:].max() < fan_in
    lay = synth.layer(dict(cfg, layer={"k": 6, "k_cur": 4}), rng(SEED, 0))
    assert lay["add"].shape[1] + lay["mult"].shape[1] == 64
    assert lay["add"][0].max() < 16 and len(lay["w"]) == 64
    assert all(0 <= v < P for v in lay["w"])
    full = synth.circuit(dict(cfg, k=20, k_input=16), rng(SEED, 0))
    assert sum(a.shape[1] + (0 if m is None else m.shape[1])
               for _, _, a, m in full["layers"]) == 2_097_168


@pytest.mark.parametrize("n", [2, 4, 8])
def test_matmul_circuit_computes_the_product(n):
    circ = matmul.circuit({"n": n})
    w = matmul.witness(circ, rng(SEED, 1))
    assert w[0] == matmul.product(w[-1], n)
    t = n.bit_length() - 1
    assert [layer[0] for layer in circ["layers"]] == list(range(2 * t, 3 * t + 1))
    assert circ["input_k"] == 2 * t + 1


def test_matmul_gate_count():
    circ = matmul.circuit({"n": 128})
    gates = sum((0 if a is None else a.shape[1]) + (0 if m is None else m.shape[1])
                for _, _, a, m in circ["layers"])
    assert gates == 4_177_920 and len(circ["layers"]) == 8


def test_gate_tuples_and_evaluate_agree_with_the_program():
    from gkr_tpu_torch.circuit import GateLayer, GKRCircuit

    circ = synth.circuit(dict(small_config("synth20"), k=7, k_input=5), rng(SEED, 0))
    inputs = [int(x) for x in rng(SEED, 5).integers(0, 2**62, size=32)]
    port = GKRCircuit([GateLayer(kc, kn, gate_tuples(a), gate_tuples(m))
                       for kc, kn, a, m in circ["layers"]], circ["input_k"])
    assert port.evaluate(inputs) == evaluate(circ["layers"], inputs)


@pytest.mark.parametrize("name", ["synth20", "matmul"])
def test_reference_equals_the_programs_host_prover_and_verifies(name):
    """The reference's whole proof equals the program's exact host engine's
    (CPU) element for element, and the program's verifier accepts it."""
    from gkr_tpu_torch.circuit import GateLayer, GKRCircuit
    from gkr_tpu_torch.proof import Proof
    from gkr_tpu_torch.prover import HostBackend, prove
    from gkr_tpu_torch.verifier import verify

    cfg = small_config(name)
    cfg = dict(cfg, k=7, k_input=5) if name == "synth20" else dict(cfg, n=4)
    gen = synth if name == "synth20" else matmul
    circ = gen.circuit(cfg, rng(SEED, 0))
    w = gen.witness(circ, rng(SEED, 1))
    port = GKRCircuit([GateLayer(kc, kn, gate_tuples(a), gate_tuples(m))
                       for kc, kn, a, m in circ["layers"]], circ["input_k"])
    z0 = [int(x) for x in rng(SEED, 2).integers(0, 2**62, size=port.k(0))]
    got = prove(port, w, z0=z0, backend=HostBackend())
    want = Reference("cpu").prove(circ["layers"], circ["input_k"], w, z0)
    compared, mismatched = proof_mismatches(got, want)
    assert compared > 100 and mismatched == 0
    ref = as_proof(want)
    assert verify(Proof(**{f: getattr(ref, f) for f in (
        "sumcheck_proofs", "sumcheck_r", "d", "q", "z", "r", "depth",
        "input_func", "k")}), port)


def test_the_programs_cpu_proof_of_the_matrix_circuit_verifies():
    """The port's pipelined prover on the CPU (its kernels' plain versions,
    tables above its host threshold) proves the n = 16 circuit, and its
    verifier accepts the proof."""
    from gkr_tpu_torch.circuit import GateLayer, GKRCircuit
    from gkr_tpu_torch.torcheng.backend import TorchBackend, prove_pipelined
    from gkr_tpu_torch.verifier import verify

    circ = matmul.circuit({"n": 16})
    w = matmul.witness(circ, rng(SEED, 1))
    assert w[0] == matmul.product(w[-1], 16)
    port = GKRCircuit([GateLayer(kc, kn, gate_tuples(a), gate_tuples(m))
                       for kc, kn, a, m in circ["layers"]], circ["input_k"])
    proof = prove_pipelined(port, w, backend=TorchBackend(device="cpu"),
                            z0=[3] * port.k(0))
    assert max(port.k_list()) == 12 and verify(proof, port)
