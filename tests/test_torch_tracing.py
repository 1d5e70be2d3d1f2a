"""The port's tracing registry (`gkr_tpu_torch.tracing`) on the CPU.

Off, a span is one shared no-op and records nothing; on, a small
`prove_pipelined` nests its spans under `walk` with one request id, a
deferred layer claim's host check keeps its claim's id, the proof is the
same as with tracing off, and under a torch profiler every span has a
profiler range of the same name and about the same duration."""

import random
import threading

import pytest
import torch

from gkr_tpu_torch import TorchBackend, prove_pipelined, tracing
from gkr_tpu_torch.circuit import synth_circuit
from gkr_tpu_torch.field import P
from gkr_tpu_torch.mimc import Mimc7
from gkr_tpu_torch.mle import mle_struct
from gkr_tpu_torch.torcheng import fused as F
from gkr_tpu_torch.torcheng import limbs as L

WALK_PARTS = {"walk.pass1", "walk.enqueue", "walk.check", "fused.download",
              "limbs.to_limbs", "backend.sparse_from_dense"}


@pytest.fixture(autouse=True)
def clean_registry():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def small():
    """A 3-layer circuit whose every layer takes the device path (on the
    CPU, the kernels' plain versions), its values and its untraced proof."""
    circuit, inputs = synth_circuit(4, 3)
    w = circuit.evaluate(inputs)
    backend = TorchBackend(device="cpu", host_threshold=0)
    return circuit, w, backend, prove_pipelined(circuit, w, backend=backend)


def _descendants(evs, i):
    out, frontier = set(), {i}
    for j, e in enumerate(evs):
        if e.parent in frontier:
            frontier.add(j)
            out.add(e.name)
    return out


def test_off_records_nothing_and_shares_one_context(small):
    circuit, w, backend, _ = small
    assert tracing.span("a") is tracing.span("b")
    assert tracing.request_id() is None
    with tracing.span("a"):
        prove_pipelined(circuit, w, backend=backend)
    assert tracing.events() == [] and tracing.totals() == {}


def test_walk_nesting_requests_and_the_same_proof(small):
    circuit, w, backend, want = small
    tracing.enable()
    got = prove_pipelined(circuit, w, backend=backend)
    got2 = prove_pipelined(circuit, w, backend=backend)
    tracing.disable()
    assert got == want and got2 == want
    evs = tracing.events()
    walks = [i for i, e in enumerate(evs) if e.name == "walk"]
    assert len(walks) == 2
    assert all(evs[i].parent == -1 for i in walks)
    for i in walks:
        parts = _descendants(evs, i)
        assert WALK_PARTS <= parts, WALK_PARTS - parts
        assert {"fused.check", "fused.rehash", "limbs.from_limbs"} <= parts
    # every span belongs to its walk's request, and the two walks differ
    reqs = {evs[i].request for i in walks}
    assert len(reqs) == 2
    root = {}
    for j, e in enumerate(evs):
        root[j] = j if e.parent == -1 else root[e.parent]
        assert e.request == evs[root[j]].request
        assert e.start_ns <= e.end_ns
        if e.parent >= 0:
            p = evs[e.parent]
            assert p.start_ns <= e.start_ns and e.end_ns <= p.end_ns
    # the three stages and the downloads sit directly under the walk
    for i in walks:
        kids = [e.name for e in evs if e.parent == i]
        assert kids.count("fused.download") == 1
        assert kids.count("walk.pass1") == kids.count("walk.enqueue") == 1
        assert kids.count("walk.check") == 1
    tot, inside = tracing.totals(), tracing.totals(within="walk")
    assert tot["walk"].calls == 2 and "walk" not in inside
    assert inside["fused.download"].calls == 4          # two syncs a walk
    assert tot["walk.check"].seconds <= tot["walk"].seconds


def test_walk_times_each_layers_mobius_and_line(small):
    """One `walk.mobius` under pass 1 and one `walk.line` under pass 2 a
    layer, inside the walk; nothing with tracing off."""
    circuit, w, backend, want = small
    assert prove_pipelined(circuit, w, backend=backend) == want
    assert tracing.events() == []
    tracing.enable()
    got = prove_pipelined(circuit, w, backend=backend)
    tracing.disable()
    assert got == want
    evs = tracing.events()
    depth = circuit.depth()
    for name, stage in (("walk.mobius", "walk.pass1"), ("walk.line", "walk.enqueue")):
        mine = [e for e in evs if e.name == name]
        assert len(mine) == depth, name
        assert all(evs[e.parent].name == stage for e in mine), name
        assert tracing.totals(within="walk")[name].calls == depth


def _claims(count):
    """`count` claims on one small layer dispatched with defer=True: ->
    their (arrays, finish) pairs."""
    rng = random.Random(3)
    k, kc = 4, 2
    n = 1 << k
    w = [rng.randrange(P) for _ in range(n)]
    add = [(rng.randrange(1 << kc), rng.randrange(n), rng.randrange(n))
           for _ in range(12)]
    mult = [(rng.randrange(1 << kc), rng.randrange(n), rng.randrange(n))
            for _ in range(12)]
    struct = mle_struct(w)
    w_dev = L.pack(w, "cpu")
    return [F.prove_layer_sumcheck_fused(
        [rng.randrange(P) for _ in range(kc)], w, add, mult, kc, k, struct,
        Mimc7(), w_dev=w_dev, defer=True, device="cpu") for _ in range(count)]


def test_deferred_claims_keep_their_request():
    """Two claims dispatched with defer=True and checked later, the second
    first: each host check carries the id of its own claim."""
    tracing.enable()
    outs = _claims(2)
    host = F.download([a for arrays, _ in outs for a in arrays])
    for i in (1, 0):
        outs[i][1](host[4 * i:4 * i + 4])
    tracing.disable()
    evs = tracing.events()
    builds = [e.request for e in evs if e.name == "fused.build_phase1"]
    checks = [e.request for e in evs if e.name == "fused.check"]
    assert len(set(builds)) == 2 and checks == builds[::-1]
    for name in ("fused.phase1_rounds", "fused.build_phase2", "fused.phase2_rounds"):
        assert [e.request for e in evs if e.name == name] == builds
    assert tracing.totals(within="fused.check")["limbs.from_limbs"].calls == 4


def test_threads_keep_their_own_parents():
    tracing.enable()
    barrier = threading.Barrier(2, timeout=10)

    def work(tag):
        with tracing.span(f"outer.{tag}"):
            barrier.wait()
            with tracing.span(f"inner.{tag}"):
                barrier.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    evs = tracing.events()
    for tag in "ab":
        (inner,) = [e for e in evs if e.name == f"inner.{tag}"]
        assert evs[inner.parent].name == f"outer.{tag}"
        assert inner.request == evs[inner.parent].request
    assert len({e.request for e in evs}) == 2


def test_full_registry_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_EVENTS", 3)
    tracing.enable()
    for _ in range(5):
        with tracing.span("x"):
            pass
    assert tracing.totals()["x"].calls == 3 and tracing.dropped() == 2
    tracing.reset()
    assert tracing.events() == [] and tracing.dropped() == 0


def test_profiler_ranges_match_the_spans():
    """A recording profiler turns tracing on; every span has a profiler
    range of its name, as many by name, each as long within max(10%,
    200 us).  Profiled: a download, three claims' host checks and a pack
    of a table (the plain kernels' many small ops are left out: the
    profiler's read-back of them costs tens of seconds)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    outs = _claims(3)
    arrays = [a for arrays, _ in outs for a in arrays]
    want = [finish(F.download(arrays)[4 * i:4 * i + 4])
            for i, (_, finish) in enumerate(outs)]
    values = list(range(64))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.request_id() is not None
        with record_function("test.warm-up"):   # the profiler's first range
            pass                                 # pays a one-off set-up
        host = F.download(arrays)
        got = [finish(host[4 * i:4 * i + 4]) for i, (_, finish) in enumerate(outs)]
        with tracing.span("test.pack"):
            L.pack(values, "cpu")
    assert tracing.request_id() is None
    assert got == want
    evs = tracing.events()
    names = {e.name for e in evs}
    assert names == {"fused.download", "fused.check", "fused.rehash",
                     "limbs.from_limbs", "limbs.to_limbs", "test.pack"}
    ranges = {}
    for fe in prof.events():
        if fe.name in names:
            ranges.setdefault(fe.name, []).append(
                (fe.time_range.start, fe.time_range.end))
    for name in names:
        spans = sorted((e.start_ns, e.end_ns) for e in evs if e.name == name)
        got_ranges = sorted(ranges.get(name, []))
        assert len(got_ranges) == len(spans), name
        for (s0, s1), (r0, r1) in zip(spans, got_ranges):
            span_us, range_us = (s1 - s0) / 1e3, r1 - r0
            assert abs(span_us - range_us) <= max(0.1 * range_us, 200.0), name
