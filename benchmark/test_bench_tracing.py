"""The readers of the program's spans (`program_span` metrics) on the CPU:
on a registry filled by the cells' drivers at small shapes, each returns
the per-proof or per-claim mean of its spans, recomputed here from the
events; nothing on an untraced run, on the other cell kind, on an empty
registry, or with a program that has no `tracing` module."""

import importlib
import sys
import time

import pytest

from benchmark import harness as H
from benchmark.conftest import small_config
from benchmark.spans import Spans

SEED = 2**31 + 77
PROVE = ("walk_enqueue_ms", "walk_wait_ms", "walk_check_ms", "to_limbs_ms")
LAYER = ("check_rehash_ms", "check_unpack_ms")
KIND = {**{name: "proofs" for name in PROVE}, **{name: "layer_claims" for name in LAYER}}


def _window(traffic_name: str):
    """One short window of the cell's driver with tracing on: -> the
    events it recorded, and the driver's kind."""
    from gkr_tpu_torch import tracing

    traffic = H.load_json(H.HERE / "traffic" / f"{traffic_name}.json")
    drivers = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    generator = importlib.import_module("benchmark.generators.synth")
    driver = drivers.Driver(small_config("synth20"), traffic, generator, SEED,
                            "cpu", Spans(False))
    driver.setup()
    tracing.reset()
    tracing.enable()
    try:
        driver.window(time.perf_counter() + 0.01)
    finally:
        tracing.disable()
    assert driver.requests and all(r.ok for r in driver.requests)
    return tracing.events(), driver.kind


def _run(kind, trace=True):
    return H.Run(kind=kind, requests=[], window=(0.0, 1.0), setup_s=0.0,
                 spans=Spans(False), launches={},
                 trace={"busy_s": 1.0, "window_s": 2.0} if trace else None,
                 shape={})


def _ms(evs, name, count_name, within=None):
    """Sum of `name`'s durations (those with an enclosing `within`, if
    given) over the number of `count_name` spans, in ms."""
    def inside(e):
        while e.parent >= 0:
            e = evs[e.parent]
            if e.name == within:
                return True
        return False

    total = sum(e.end_ns - e.start_ns for e in evs
                if e.name == name and (within is None or inside(e)))
    return total / 1e6 / sum(e.name == count_name for e in evs)


@pytest.fixture(autouse=True)
def empty_registry():
    from gkr_tpu_torch import tracing
    tracing.reset()
    yield
    tracing.reset()


def _read(name, run):
    return H.load_metric(name).read(run)


def test_prove_readers():
    evs, kind = _window("prove")
    run = _run(kind)
    assert _read("walk_enqueue_ms", run) == pytest.approx(_ms(evs, "walk.enqueue", "walk"))
    assert _read("walk_check_ms", run) == pytest.approx(_ms(evs, "walk.check", "walk"))
    assert _read("walk_wait_ms", run) == pytest.approx(
        _ms(evs, "fused.download", "walk", within="walk"))
    assert _read("to_limbs_ms", run) == pytest.approx(
        _ms(evs, "limbs.to_limbs", "walk", within="walk"))
    for name in PROVE:
        assert _read(name, run) > 0
        assert _read(name, _run(kind, trace=False)) is None
        assert _read(name, _run("layer_claims")) is None
    for name in LAYER:
        assert _read(name, run) is None


def test_layer_readers():
    evs, kind = _window("layer")
    run = _run(kind)
    assert sum(e.name == "fused.check" for e in evs) == 6       # one batch
    assert _read("check_rehash_ms", run) == pytest.approx(
        _ms(evs, "fused.rehash", "fused.check"))
    assert _read("check_unpack_ms", run) == pytest.approx(
        _ms(evs, "limbs.from_limbs", "fused.check", within="fused.check"))
    for name in LAYER:
        assert _read(name, run) > 0
        assert _read(name, _run(kind, trace=False)) is None
        assert _read(name, _run("proofs")) is None
    for name in PROVE:
        assert _read(name, run) is None


def test_nothing_without_spans(monkeypatch):
    """An empty registry, and a program without `tracing` (the parent of
    the change that added it), give nothing and raise nothing."""
    import gkr_tpu_torch

    for name, kind in KIND.items():
        assert _read(name, _run(kind)) is None
    monkeypatch.delattr(gkr_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "gkr_tpu_torch.tracing", None)
    for name, kind in KIND.items():
        assert _read(name, _run(kind)) is None

