"""The port's multi-controller path on the CPU: two gloo ranks, each a
process of one torch.distributed group, proving each layer's shards
together over `make_mesh(hosts=2)` (gkr_tpu_torch.parallel.multihost), held
to gkr_tpu's exact host engine and to the port's single-controller sharded
engine at the same global D.  Field arithmetic is exact: transcripts and
proofs must be identical.

The ranks are spawned once for the module (one torch thread each, a
`file://` store under the test's temporary directory) and run every job
there; the tests read their results.  gkr_tpu's own multi-host harness
(scripts/run_multihost.py) is not run: it compiles JAX's sharded engine."""

import random

import pytest
import torch
import torch.distributed as dist

import gkr_tpu
from gkr_tpu.mle import MleStruct as HostMleStruct
from gkr_tpu.mle import mle_struct as host_mle_struct
from gkr_tpu.sumcheck import prove_layer_sumcheck as host_layer_sumcheck

import gkr_tpu_torch as port
from gkr_tpu_torch.circuit import synth_circuit
from gkr_tpu_torch.mimc import Mimc7
from gkr_tpu_torch.mle import mle_struct
from gkr_tpu_torch.parallel import HostMesh, ShardedBackend, ShardedSumcheck, make_mesh
from gkr_tpu_torch.parallel import multihost, scaling
from gkr_tpu_torch.recursion import subcircuits

from test_gkr_e2e import assert_proofs_identical

CPU = torch.device("cpu")
K_LAYER = {4: 8, 1: 6, 2: 6}         # d_local -> k: run_multihost.py's k = 8 at 2 x 4
LAYERS = {4: 0, 1: 1, 2: 2}          # d_local -> index of its layer job
HOT = dict(k_cur=4, k_next=4, hot=1 << 16, seed=3)
PROVE = dict(k=5, k_input=4)
JOBS = [*(("layer", {"k": K_LAYER[d], "reps": 1, "d_local": d, "check_host": d == 4})
          for d in LAYERS),
        ("hot", {**HOT, "d_local": 2}),
        ("prove", {**PROVE, "host_threshold": 0, "reps": 1, "with_proof": True,
                   "d_local": 2}),
        ("layer", {"k": 6, "d_local": 1, "tamper_round": 3})]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs its files in parallel workers; torch's intra-op threads
    buy these small tables nothing and take cores from the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks():
    """Every job on 2 ranks of the CPU -> [rank 0's results, rank 1's]."""
    return multihost.spawn(JOBS, hosts=2, d_local=4, device="cpu", threads=1,
                           timeout=120, log=lambda s: None)


@pytest.mark.parametrize("d_local", [1, 2, 4])
def test_ranks_prove_the_host_engines_layer(ranks, d_local):
    """2 ranks x d_local shards (global D = 2, 4, 8) on run_multihost.py's
    layer (k = 8 at 2 x 4 shards, its default; k = 6 else): each rank's
    transcript is gkr_tpu's host engine's and the single-controller
    engine's at the same D; at 2 x 4 rank 0 also held it to the port's
    host engine in the child."""
    k = K_LAYER[d_local]
    got = [(r[LAYERS[d_local]]["proof"], r[LAYERS[d_local]]["challenges"])
           for r in ranks]
    assert [r[LAYERS[d_local]]["D"] for r in ranks] == [2 * d_local] * 2
    z, w, ag, mg, kc, struct = multihost.synth(k)
    host = tuple(host_layer_sumcheck(z, w, ag, mg, kc, k,
                                     HostMleStruct(k, False, [True] * k, k),
                                     gkr_tpu.Mimc7()))
    single = ShardedSumcheck([CPU] * (2 * d_local)).prove_layer_sumcheck(
        z, w, ag, mg, kc, k, struct, Mimc7())
    assert got == [tuple(map(list, host))] * 2
    assert single == host
    if d_local == 4:
        assert ranks[0][0]["transcript_matches_host_engine"] is True


@pytest.mark.parametrize("d_local", [1, 2, 4])
def test_collectives_a_rank(ranks, d_local):
    """A rank's collectives for one layer: one gather a local round and one
    tail gather a phase, as the single controller's, and one digest
    exchange; the bytes each gathered.  (On the CPU the kernel wrappers run
    their plain versions and count no launch: chip_smoke.py [14] counts a
    rank's launches on the card.)"""
    counts, nbytes = scaling.expected_collectives(K_LAYER[d_local], 2 * d_local)
    counts["digest"], nbytes["digest"] = 1, 2 * 32
    for r in ranks:
        res = r[LAYERS[d_local]]
        assert res["collectives"] == counts
        assert res["collective_bytes"] == nbytes
        assert res["launches"] == {}


def test_hot_bucket_in_rank_1(ranks):
    """2^16 add gates on one left input, a bucket of rank 1's first shard
    (global D = 4): the segment sum carries past 16 bits on rank 1 alone,
    and both ranks' transcripts are gkr_tpu's host engine's."""
    res = [r[3] for r in ranks]
    assert res[0]["left"] == res[1]["left"] == 2
    z, w, add, mult = multihost.hot_layer(left=2, **HOT)
    want = host_layer_sumcheck(z, w, add, mult, HOT["k_cur"], HOT["k_next"],
                               host_mle_struct(w), gkr_tpu.Mimc7())
    for r in res:
        assert (r["proof"], r["challenges"]) == tuple(map(list, want))
    # phase 1 keys on the left input: rank 1's first shard holds the bucket
    assert res[0]["row0_add_gates"] == [0, 0]
    assert res[1]["row0_add_gates"] == [1 << 16, 0]


def test_prove_through_sharded_backend(ranks):
    """synth_circuit(5, 4) (layers at k_next 5, 5, 4, all on the engine)
    through ShardedBackend(make_mesh(hosts=2)) at 2 x 2 shards: both ranks'
    proofs are the same bytes, gkr_tpu's host engine's and the port's
    single-controller engine's over D = 4."""
    res = [r[4] for r in ranks]
    assert res[0]["digest"] == res[1]["digest"]
    assert res[0]["proof"] == res[1]["proof"]
    pc, inputs = synth_circuit(**PROVE)
    c = gkr_tpu.GKRCircuit([gkr_tpu.GateLayer(l.k_cur, l.k_next, l.add_gates,
                                              l.mult_gates) for l in pc.layers],
                           pc.input_k)
    host = gkr_tpu.prove(c, c.evaluate(inputs))
    assert_proofs_identical(port.Proof.from_dict(res[0]["proof"]), host)
    single = port.prove(pc, pc.evaluate(inputs),
                        backend=ShardedBackend([CPU] * 4, host_threshold=0))
    assert single.to_dict() == res[0]["proof"]
    assert [r["collectives"]["digest"] for r in res] == [3, 3]     # one a layer


def test_a_divergent_challenge_raises_on_every_rank(ranks):
    """Rank 1's device challenge of round 3 corrupted: the layer's challenge
    digests differ, and every rank raises."""
    for r in ranks:
        assert "challenges differ" in r[5]["raised"]


def test_the_ranks_import_no_jax(ranks):
    for r in ranks:
        assert all(job["foreign_modules"] == [] for job in r)


def test_make_mesh_hosts_needs_a_process_group(tmp_path):
    """Without an initialized default group make_mesh(hosts=) raises; with
    one of another world size too; with world size 1 it is a HostMesh of
    this process's shards."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no initialized default process group"):
        make_mesh(devices=["cpu"] * 2, hosts=2)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="has 1 processes"):
            make_mesh(devices=["cpu"] * 2, hosts=2)
        with pytest.raises(ValueError, match="power of two"):
            make_mesh(devices=["cpu"] * 3, hosts=1)
        mesh = make_mesh(devices=["cpu"] * 2, hosts=1)
        assert mesh == HostMesh(1, 0, 2, (CPU, CPU), "gloo")
        rng = random.Random(4)
        w = [rng.randrange(port.field.P) for _ in range(16)]
        add = [(o, rng.randrange(16), rng.randrange(16)) for o in range(16)]
        z = [rng.randrange(port.field.P) for _ in range(4)]
        got = ShardedSumcheck(mesh).prove_layer_sumcheck(
            z, w, add, [], 4, 4, mle_struct(w), Mimc7())
        want = host_layer_sumcheck(z, w, add, [], 4, 4, host_mle_struct(w),
                                   gkr_tpu.Mimc7())
        assert got == tuple(want)
    finally:
        dist.destroy_process_group()


def test_scaling_twin(capsys):
    """bench_scaling.py's twin at a toy size on the CPU: every row shared
    (one device), so no headline; the audit is the engine's rule."""
    assert scaling.main(["4", "1", "1,2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    res = __import__("json").loads(out)
    assert set(res["rows"]) == {"1", "2"}
    assert res["rows"]["2"]["shared"] and not res["rows"]["1"]["shared"]
    assert res["headline_efficiency"] is None
    assert res["collective_audit"]["2"]["collectives"] == {
        "round": 6, "tail": 2, "digest": 0, "mesh": 0}
    assert res["transcript_identical_across_D"] is True


def test_subcircuits_twin(capsys):
    """bench_subcircuits.py's twin at a toy size on the CPU: both pools'
    keys, the same proofs at every worker count."""
    assert subcircuits.main(["2", "4", "--workers", "1,2", "--device", "cpu"]) == 0
    res = __import__("json").loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"metric", "pool", "host_cpus", "total_gates", "sequential_s", "wall_s",
            "speedup_vs_sequential", "torch"} <= set(res)
    assert set(res["wall_s"]) == set(res["torch"]["wall_s"]) == {"1", "2"}


def test_a_failing_rank_fails_the_run():
    """A job no rank knows: every rank exits non-zero, and `spawn` raises
    with each rank's output."""
    with pytest.raises(RuntimeError, match="a rank failed") as err:
        multihost.spawn([("no_such_job", {})], hosts=2, d_local=1, device="cpu",
                        threads=1, timeout=120, log=lambda s: None)
    text = str(err.value)
    assert "--- rank 0 (rc 1)" in text and "--- rank 1 (rc 1)" in text
    assert text.count("KeyError: 'no_such_job'") == 2
