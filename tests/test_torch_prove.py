"""The port's full prove() against the JAX package on the CPU, and the
port's rules.

The port's per-round engine (TorchBackend(fused=False)) is compared with
the per-round JAX engine (JaxBackend(fused=False)) and with gkr_tpu's exact
host engine; the fused engine, the default, with the host engine (here and
in test_torch_fused.py).  A port proof must load into gkr_tpu.proof.Proof
and pass gkr_tpu.verify.  Field arithmetic is exact: proofs must be
identical."""

import os
import random
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import gkr_tpu
from gkr_tpu.jaxeng.backend import JaxBackend
from gkr_tpu.proof import Proof as JaxProof
from gkr_tpu.prover import HostBackend as JaxHostBackend

import gkr_tpu_torch as port
from gkr_tpu_torch.circuit import synth_circuit
from gkr_tpu_torch.convert import circuit_from
from gkr_tpu_torch.field import P
from gkr_tpu_torch.torcheng import kernels as K

from test_gkr_e2e import (assert_proofs_identical, random_circuit,
                          reference_toy_circuit)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs its files in parallel workers; torch's intra-op threads
    buy these small limb tensors nothing and take cores from the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cpu_backend(**kw):
    return port.TorchBackend(device="cpu", **kw)


def jax_circuit(pc):
    return gkr_tpu.GKRCircuit(
        [gkr_tpu.GateLayer(l.k_cur, l.k_next, l.add_gates, l.mult_gates)
         for l in pc.layers], pc.input_k)


@pytest.mark.parametrize("case", ["toy", "seed5", "seed9"])
def test_prove_matches_jax_per_round_engine(case):
    """Every layer on the device path down to one-entry tables."""
    if case == "toy":
        c, inputs = reference_toy_circuit()
    else:
        c, inputs = random_circuit(random.Random(int(case[4:])), depth=2,
                                   max_k=2)
    want = gkr_tpu.prove(c, c.evaluate(inputs), backend=JaxBackend(
        host_threshold=0, tail_threshold=1, fused=False))
    pc = circuit_from(c)
    K.reset_launches()
    got = port.prove(pc, pc.evaluate(inputs),
                     backend=cpu_backend(host_threshold=0, tail_threshold=1,
                                         fused=False))
    assert not any(K.LAUNCHES.values())
    assert_proofs_identical(got, want)
    assert port.verify(got, pc, raise_on_fail=True)


@pytest.mark.parametrize("seed", [0, 9])
def test_prove_matches_host_engine(seed):
    c, inputs = random_circuit(random.Random(seed), depth=3, max_k=3)
    w = c.evaluate(inputs)
    pc = circuit_from(c)
    got = port.prove(pc, pc.evaluate(inputs),
                     backend=cpu_backend(host_threshold=0, tail_threshold=2,
                                         fused=False))
    assert_proofs_identical(got, gkr_tpu.prove(c, w))


def test_device_sized_circuit_matches_host_engine():
    """synth_circuit(12, 10) against gkr_tpu's HostBackend: the per-round
    engine (device rounds on 2^12 tables, host tail below 2^8) and the fused
    engine (every round of the two k = 12 layers on the device path); the
    kernel counters stay 0."""
    pc, inputs = synth_circuit(12, 10)
    w = pc.evaluate(inputs)
    K.reset_launches()
    got = port.prove(pc, w, backend=cpu_backend(tail_threshold=1 << 8,
                                                fused=False))
    fused = port.prove(pc, w, backend=cpu_backend())
    assert not any(K.LAUNCHES.values())
    jc = jax_circuit(pc)
    want = gkr_tpu.prove(jc, jc.evaluate(inputs), backend=JaxHostBackend())
    assert_proofs_identical(got, want)
    assert_proofs_identical(fused, want)
    assert port.verify(got, pc, raise_on_fail=True)


def test_json_into_gkr_tpu_verifier_and_tamper():
    c, inputs = random_circuit(random.Random(5), depth=2, max_k=3)
    pc = circuit_from(c)
    proof = port.prove(pc, pc.evaluate(inputs),
                       backend=cpu_backend(host_threshold=0, tail_threshold=1))
    s = proof.to_json()
    jp = JaxProof.from_json(s)
    assert jp.to_json() == s
    assert gkr_tpu.verify(jp, c, raise_on_fail=True)
    for mutate in [
        lambda p: p.sumcheck_proofs[0][0].__setitem__(
            0, (p.sumcheck_proofs[0][0][0] + 1) % P),
        lambda p: p.sumcheck_r[1].__setitem__(0, (p.sumcheck_r[1][0] + 1) % P),
        lambda p: p.q[0].__setitem__(0, (p.q[0][0] + 1) % P),
        lambda p: p.r.__setitem__(0, (p.r[0] + 1) % P),
        lambda p: p.z[1].__setitem__(0, (p.z[1][0] + 1) % P),
    ]:
        bad = port.Proof.from_json(s)
        mutate(bad)
        assert not port.verify(bad, pc)


def test_torch_backend_needs_a_card(monkeypatch):
    """No silent CPU fallback: the default device is the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.TorchBackend()
    c, inputs = reference_toy_circuit()
    pc = circuit_from(c)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.prove(pc, pc.evaluate(inputs))
    assert port.TorchBackend(device="cpu").device.type == "cpu"


def test_fused_engine_is_the_default():
    """As JaxBackend's: fused=True unless the per-round engine is asked for."""
    b = port.TorchBackend(device="cpu")
    assert (b.host_threshold, b.tail_threshold, b.fused) == (10, 1 << 12, True)
    assert not port.TorchBackend(device="cpu", fused=False).fused


def test_import_leaves_jax_and_gkr_tpu_out():
    code = ("import sys, gkr_tpu_torch, gkr_tpu_torch.convert, "
            "gkr_tpu_torch.torcheng.kernels, gkr_tpu_torch.torcheng.backend, "
            "gkr_tpu_torch.torcheng.fused, gkr_tpu_torch.bench, "
            "gkr_tpu_torch.probes, gkr_tpu_torch.cli, gkr_tpu_torch.frontend, "
            "gkr_tpu_torch.recursion.aggregator\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'gkr_tpu', 'bench', 'scripts')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, env=env,
                   timeout=120)


def test_sources_import_no_jax_or_gkr_tpu():
    """No module of the port, nor chip_smoke.py, imports jax, gkr_tpu, the
    JAX bench (bench.py) or its scripts."""
    files = sorted((ROOT / "gkr_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|gkr_tpu|bench|scripts)\b", re.M)
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if pat.search(f.read_text())]
    assert len(files) > 10
    assert {"bench.py", "probes.py"} <= {f.name for f in files}
    names = {str(f.relative_to(ROOT / "gkr_tpu_torch")) for f in files[:-1]}
    assert {"cli.py", "__main__.py", "examples.py", "frontend/r1cs.py",
            "frontend/wtns.py", "frontend/symfile.py", "frontend/compiler.py",
            "recursion/serialize.py", "recursion/templating.py",
            "recursion/native.py", "recursion/circom_driver.py",
            "recursion/aggregator.py"} <= names
    assert offenders == []


def test_chip_smoke_alone_fails(tmp_path):
    """Without a card, or without the repository beside it, chip_smoke.py
    exits non-zero and prints no result line."""
    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
