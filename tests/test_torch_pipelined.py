"""The port's prove_pipelined against gkr_tpu's exact host engine on the CPU.

prove_pipelined keeps the z-chain, r* and the line points on the device and
syncs twice a proof; its proofs must equal those of gkr_tpu.prove on the
host engine, which tests/test_backend_pipelined.py holds the JAX package's
prove_pipelined to.  No JAX program is compiled here.  Field arithmetic is
exact: proofs must be identical (tolerance: none)."""

import random

import pytest
import torch

import gkr_tpu
from gkr_tpu.field import P
from gkr_tpu.prover import HostBackend as JaxHostBackend

import gkr_tpu_torch as port
from gkr_tpu_torch.circuit import synth_circuit
from gkr_tpu_torch.convert import circuit_from
from gkr_tpu_torch.torcheng import backend as B
from gkr_tpu_torch.torcheng import fused as F
from gkr_tpu_torch.torcheng import kernels as K

from test_gkr_e2e import assert_proofs_identical, random_circuit


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs its files in parallel workers; torch's intra-op threads
    buy these small limb tensors nothing and take cores from the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def pipelined(pc, w, **kw):
    """prove_pipelined with every layer on the CPU's device path: -> (proof,
    the downloads it made).  No kernel may launch."""
    K.reset_launches()
    downloads = F.DOWNLOADS
    proof = port.prove_pipelined(
        pc, w, backend=port.TorchBackend(device="cpu", host_threshold=0), **kw)
    assert not any(K.LAUNCHES.values())
    return proof, F.DOWNLOADS - downloads


@pytest.mark.parametrize("seed", [1, 4, 8])
def test_pipelined_matches_host_engine(seed):
    c, inputs = random_circuit(random.Random(seed), depth=2, max_k=3)
    want = gkr_tpu.prove(c, c.evaluate(inputs), backend=JaxHostBackend())
    pc = circuit_from(c)
    got, downloads = pipelined(pc, pc.evaluate(inputs))
    assert downloads == 2
    assert_proofs_identical(got, want)
    assert port.verify(got, pc, raise_on_fail=True)


def test_pipelined_zero_heavy_layers():
    """Empty and partial-support inner tables (struct.empty, dropped
    variables) through the device z-chain."""
    layers = [gkr_tpu.GateLayer(1, 2, mult_gates=[(0, 0, 1), (1, 2, 3)]),
              gkr_tpu.GateLayer(2, 2, add_gates=[(0, 0, 1), (1, 1, 2),
                                                 (2, 2, 3), (3, 3, 0)])]
    c = gkr_tpu.GKRCircuit(layers=layers, input_k=2)
    w = c.evaluate([5, 7, 5, 7])            # x_1 unsupported in the input MLE
    pc = circuit_from(c)
    got, downloads = pipelined(pc, pc.evaluate([5, 7, 5, 7]))
    assert downloads == 2
    assert_proofs_identical(got, gkr_tpu.prove(c, w, backend=JaxHostBackend()))
    assert port.verify(got, pc, raise_on_fail=True)


def test_pipelined_random_z0():
    rng = random.Random(3)
    c, inputs = random_circuit(rng, depth=2, max_k=3)
    z0 = [rng.randrange(P) for _ in range(c.k(0))]
    want = gkr_tpu.prove(c, c.evaluate(inputs), z0=z0, backend=JaxHostBackend())
    pc = circuit_from(c)
    got, _ = pipelined(pc, pc.evaluate(inputs), z0=z0)
    assert_proofs_identical(got, want)


@pytest.fixture(scope="module")
def synth12():
    """synth_circuit(12, 10), its tables and gkr_tpu's host-engine proof."""
    pc, inputs = synth_circuit(12, 10)
    jc = gkr_tpu.GKRCircuit(
        [gkr_tpu.GateLayer(l.k_cur, l.k_next, l.add_gates, l.mult_gates)
         for l in pc.layers], pc.input_k)
    return pc, pc.evaluate(inputs), gkr_tpu.prove(jc, jc.evaluate(inputs),
                                                  backend=JaxHostBackend())


def test_pipelined_device_sized_circuit(synth12):
    """Every round of the two k = 12 layers and the k = 10 layer on the
    device path, two downloads in all."""
    pc, w, want = synth12
    got, downloads = pipelined(pc, w)
    assert downloads == 2
    assert_proofs_identical(got, want)


def test_pipelined_raises_on_a_corrupted_r_star(monkeypatch):
    """A device r* that is not the host's MiMC of the last round's
    coefficients fails the host check."""
    c, inputs = random_circuit(random.Random(4), depth=2, max_k=3)
    pc = circuit_from(c)
    real = B._line_challenge

    def corrupted(last, length):
        r = real(last, length).clone()
        r[0] ^= 1
        return r

    monkeypatch.setattr(B, "_line_challenge", corrupted)
    with pytest.raises(RuntimeError, match=r"divergence at layer 0 r\*"):
        port.prove_pipelined(pc, pc.evaluate(inputs),
                             backend=port.TorchBackend(device="cpu", host_threshold=0))
