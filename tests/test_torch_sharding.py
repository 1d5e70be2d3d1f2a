"""The port's multi-device engine (gkr_tpu_torch.parallel) on the CPU: D = 1,
2, 4 and 8 shards on one device, each with its own tables, proving as
gkr_tpu's exact host engine and the port's single-device fused engine do.

The circuits are drawn as the JAX package's sharding tests draw theirs
(`test_sharding.wide_circuit`: a 2^k-gate layer of random add and mult
gates over a 2^k-entry layer), proved there by the host engine only: no
JAX mesh is built here.  Field arithmetic is exact, so proofs must be
identical."""

import argparse
import contextlib
import io
import json
import random
from functools import partial
from pathlib import Path

import pytest
import torch

import gkr_tpu
from gkr_tpu.mle import mle_struct as host_mle_struct
from gkr_tpu.sumcheck import prove_layer_sumcheck as host_layer_sumcheck

import gkr_tpu_torch as port
from gkr_tpu_torch import cli
from gkr_tpu_torch import frontend as F
from gkr_tpu_torch.convert import circuit_from
from gkr_tpu_torch.field import P
from gkr_tpu_torch.mimc import Mimc7
from gkr_tpu_torch.mle import mle_struct
from gkr_tpu_torch.parallel import ShardedBackend, ShardedSumcheck, make_mesh
from gkr_tpu_torch.parallel import sharding as S
from gkr_tpu_torch.recursion import aggregator
from gkr_tpu_torch.torcheng import kernels as K

from test_gkr_e2e import assert_proofs_identical

FIX = Path(__file__).resolve().parent / "fixtures" / "circom_mimc"
R1CS, WTNS = str(FIX / "circuit.r1cs"), str(FIX / "witness.wtns")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs its files in parallel workers; torch's intra-op threads
    buy these small tables nothing and take cores from the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def shards(D, **kw):
    return ShardedBackend(make_mesh(devices=["cpu"] * D), **kw)


def test_make_mesh():
    assert make_mesh(devices=["cpu"] * 4) == [CPU] * 4
    assert make_mesh(8, devices=["cpu"]) == [CPU] * 8        # taken in turn
    assert make_mesh(2, devices=["cpu"] * 4) == [CPU] * 2
    with pytest.raises(ValueError, match="power of two"):
        make_mesh(devices=["cpu"] * 3)
    with pytest.raises(RuntimeError, match="no initialized default process group"):
        make_mesh(devices=["cpu"] * 2, hosts=2)
    with pytest.raises(ValueError, match="power of two"):
        ShardedSumcheck([CPU] * 6)


def test_no_card_no_mesh(monkeypatch):
    """The default mesh is the visible cards; without one it raises, as
    TorchBackend() does, and so does a mesh that names a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (make_mesh, ShardedBackend, lambda: make_mesh(devices=["cuda"] * 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


@pytest.fixture(scope="module")
def wide():
    """A wide layer, 16 gates (each an add or a mult gate, at random) over
    16 entries, proved at a random point z0 (so every gate's weight
    eq(z0, out) is a full field element); its values and the two
    references: gkr_tpu's host engine and the port's fused engine on the
    CPU -> (port circuit, values, z0, host proof)."""
    rng = random.Random(1)
    k = 4
    add, mult = [], []
    for o in range(1 << k):
        (add if rng.random() < 0.5 else mult).append(
            (o, rng.randrange(1 << k), rng.randrange(1 << k)))
    c = gkr_tpu.GKRCircuit([gkr_tpu.GateLayer(k, k, add, mult)], k)
    inputs = [rng.randrange(P) for _ in range(1 << k)]
    z0 = [rng.randrange(P) for _ in range(k)]
    pc = circuit_from(c)
    w = pc.evaluate(inputs)
    host = gkr_tpu.prove(c, c.evaluate(inputs), z0=z0)
    fused = port.prove(pc, w, z0=z0,
                       backend=port.TorchBackend(device="cpu", host_threshold=0))
    assert_proofs_identical(fused, host)
    return pc, w, z0, host


@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_sharded_prove_matches_host_engine(wide, D):
    """The layer sumcheck on the sharded engine (host_threshold 0): 16
    entries a table, so D = 8 takes one local round a phase and three in
    the gathered tail; D = 1 is the fused engine with the eq(b*)
    factors."""
    pc, w, z0, host = wide
    K.reset_launches()
    got = port.prove(pc, w, z0=z0, backend=shards(D, host_threshold=0))
    assert not any(K.LAUNCHES.values())
    assert_proofs_identical(got, host)


def test_sharded_layers_match_host_engine(monkeypatch):
    """Two layers over 2^4-entry tables (ks 2, 4, 4) through the sharded
    engine over D = 2 shards (three local rounds a phase, one in the tail;
    `wide` takes D = 1 to 8), so the z-chain runs from layer to layer and
    each layer has its own cached plans: the output layer's add gates at
    random and its mult gates on inputs 0 and 8 only (shard 1 holds no
    mult gate and builds zeros), then a layer of mult gates only; the proof
    at a random z0 is gkr_tpu's host engine's."""
    rng = random.Random(2)
    out = [(0, rng.randrange(16), rng.randrange(16)), (1, rng.randrange(16), 0)]
    layers = [gkr_tpu.GateLayer(2, 4, out, [(2, 0, 8), (3, 8, 8)]),
              gkr_tpu.GateLayer(4, 4, [], [(o, rng.randrange(16), rng.randrange(16))
                                           for o in range(16)])]
    c = gkr_tpu.GKRCircuit(layers, 4)
    inputs = [rng.randrange(P) for _ in range(16)]
    z0 = [rng.randrange(P) for _ in range(2)]
    host = gkr_tpu.prove(c, c.evaluate(inputs), z0=z0)
    pc = circuit_from(c)
    layer = pc.layers[0]
    plans = S.shard_plans(layer.add_gates, layer.mult_gates, 16, [CPU] * 2)
    assert [p.m1 is None for p in plans] == [False, True]
    calls = []
    real = ShardedSumcheck.prove_layer_sumcheck
    monkeypatch.setattr(ShardedSumcheck, "prove_layer_sumcheck",
                        lambda self, *a, **kw: calls.append(kw["layer_idx"])
                        or real(self, *a, **kw))
    backend = shards(2, host_threshold=0)
    got = port.prove(pc, pc.evaluate(inputs), z0=z0, backend=backend)
    assert calls == [1, 2]
    assert sorted(backend._sharded._plans) == [1, 2]
    assert_proofs_identical(got, host)


def test_hot_bucket_in_one_shard():
    """A layer sumcheck with 2^16 add gates that all share left input 0,
    one bucket of shard 0 in phase 1, at a random point z (so the bucket's
    weights are full field elements): its segment sums carry past 16 bits,
    and the transcript is gkr_tpu's host engine's.  The gates share 16
    outputs (the wiring predicate sums over gates, so both engines take
    them as they come): the eq(z) table stays small on the CPU."""
    rng = random.Random(3)
    n_gates, k_cur, k_next = 1 << 16, 4, 4
    add = [(o % (1 << k_cur), 0, right)
           for o, right in enumerate(rng.choices(range(1 << k_next), k=n_gates))]
    mult = []
    w_next = [rng.randrange(P) for _ in range(1 << k_next)]
    z = [rng.randrange(P) for _ in range(k_cur)]
    mesh = [CPU] * 2
    assert int(S.shard_plans(add, mult, 1 << k_next, mesh)[0].a1.hib[0]) == n_gates
    got = ShardedSumcheck(mesh).prove_layer_sumcheck(
        z, w_next, add, mult, k_cur, k_next, mle_struct(w_next), Mimc7())
    want = host_layer_sumcheck(z, w_next, add, mult, k_cur, k_next,
                               host_mle_struct(w_next), gkr_tpu.Mimc7())
    assert got == tuple(want)


def test_small_table_goes_to_the_host_engine(wide, monkeypatch):
    """n // D < 2: the 2^4 table over 16 shards is proved by the exact host
    engine, its transcript unchanged."""
    pc, w, z0, host = wide
    calls = []
    real = S.prove_layer_sumcheck
    monkeypatch.setattr(S, "prove_layer_sumcheck",
                        lambda *a, **kw: calls.append(a[5]) or real(*a, **kw))
    got = port.prove(pc, w, z0=z0, backend=shards(16, host_threshold=0))
    assert calls == [4]
    assert_proofs_identical(got, host)


def test_corrupted_device_challenge_raises(wide, monkeypatch):
    """A challenge the device got wrong (one limb of round 3's, then folded
    with) fails the host's re-hash of that round."""
    pc, w, z0, _ = wide
    real, seen = K.round_tail, []

    def corrupt(partials, length):
        co, r = real(partials, length)
        seen.append(r)
        if len(seen) == 3:
            r = r.clone()
            r[0] ^= 1
        return co, r

    monkeypatch.setattr(K, "round_tail", corrupt)
    with pytest.raises(RuntimeError, match="divergence at round 3"):
        port.prove(pc, w, z0=z0, backend=shards(2, host_threshold=0))


def run_cli(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_aggregator_keeps_sharded_off_the_pipelined_walk(wide, monkeypatch):
    """On a card, `prove_subcircuits` (every CLI command's path) sends a
    TorchBackend to `prove_pipelined`, which proves on one device, and a
    ShardedBackend to `prove()`, which calls its sharded layer sumcheck.
    The card is stood in for by the backends' device type."""
    pc, w, _, _ = wide
    seen = []
    monkeypatch.setattr(aggregator, "prove_pipelined",
                        lambda c, w, backend: seen.append(("pipelined", type(backend))))
    monkeypatch.setattr(aggregator, "prove",
                        lambda c, w, backend: seen.append(("prove", type(backend))))
    for backend in (port.TorchBackend(device="cpu", host_threshold=0),
                    shards(2, host_threshold=0)):
        backend.device = argparse.Namespace(type="cuda")
        aggregator.prove_subcircuits([pc], [w], backend=backend, check_verify=False)
    assert seen == [("pipelined", port.TorchBackend), ("prove", ShardedBackend)]


def test_cli_backend_sharded(tmp_path, monkeypatch):
    """`prove-r1cs --backend sharded --device cpu --devices 2` on the
    fixture's first two constraints (two subcircuits, layers at k_next 1,
    2 and 2), with the host threshold lowered to 0: each subcircuit's
    k_next = 2 layers run on the sharded engine (2 rows a shard), its
    k_next = 1 layer goes on to the host engine, and the output is
    `--backend host`'s; D and the devices go to stderr once.  --device
    and --devices are refused with another backend.  Without --device cpu
    and without a card it raises as --backend torch does, and writes
    nothing."""
    r1cs = F.R1csFile.read(R1CS)
    h = r1cs.header
    small = str(tmp_path / "small.r1cs")
    F.R1csFile.write(small, P, n_wires=h.n_wires, n_pub_out=h.n_pub_out,
                     n_pub_in=h.n_pub_in, n_prv_in=h.n_prv_in,
                     constraints=r1cs.constraints[:2])
    args = ["prove-r1cs", "--r1cs", small, "--wtns", WTNS]

    sharded, on_host = [], []
    real, real_host = ShardedSumcheck.prove_layer_sumcheck, S.prove_layer_sumcheck
    monkeypatch.setattr(ShardedSumcheck, "prove_layer_sumcheck",
                        lambda self, *a, **kw: sharded.append(a[5]) or real(self, *a, **kw))
    monkeypatch.setattr(S, "prove_layer_sumcheck",
                        lambda *a: on_host.append(a[5]) or real_host(*a))
    monkeypatch.setattr(S, "ShardedBackend", partial(ShardedBackend, host_threshold=0))
    out, want = tmp_path / "proofs.json", tmp_path / "host.json"
    rc, text, err = run_cli(args + ["--backend", "sharded", "--device", "cpu",
                                    "--devices", "2", "-o", str(out)])
    assert rc == 0 and "2 subcircuit proof(s)" in text
    assert err.splitlines() == ["sharded backend: D = 2 shards on cpu"]
    assert sharded == [1, 2, 2] * 2 and on_host == [1] * 2
    assert run_cli(args + ["--backend", "host", "-o", str(want)])[0] == 0
    assert json.loads(out.read_text()) == json.loads(want.read_text())

    got = cli._backend_args(argparse.Namespace(backend="sharded", workers=None,
                                               device="cpu", devices=2))
    assert got["max_workers"] == 1 and isinstance(got["backend"], ShardedBackend)
    assert got["backend"].mesh == [CPU] * 2
    for extra in (["--backend", "torch", "--devices", "2"],
                  ["--backend", "host", "--device", "cpu"]):
        with pytest.raises(SystemExit):
            run_cli(args + extra)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bad = tmp_path / "nocard.json"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_cli(args + ["--backend", "sharded", "-o", str(bad)])
    assert not bad.exists()
