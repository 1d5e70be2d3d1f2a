"""The aggregator's round-1 configuration (`generators/mimc_agg.py`) and the
per-layer metrics added with it, on the CPU; and its control at the cell's
own size on the card.

The small configuration is the same generator with the repository's
`square_chain_example` as the user circuit, at full strength: 15,488
constraints, 7 layers over tables of 2^14 and 2^15 entries, above the
program's host threshold, so the device path runs (on the CPU, in the
kernels' plain versions; one run takes ~2 min).

    python -m pytest benchmark/test_bench_mimc_agg.py -q -p no:cacheprovider
    python -m pytest -o addopts="" benchmark/test_bench_mimc_agg.py -q -m card -s
"""

import json
import time

import pytest

from benchmark import harness as H
from benchmark.generators import mimc_agg as M
from benchmark.generators.common import gate_tuples, rng
from benchmark.spans import Spans

WORKLOAD = "mimc_agg.r1_prove"
CONTROL_ROUNDS = 90
SMALL = {"name": "mimc_agg", "generator": "mimc_agg", "example": "square_chain",
         "constraints": 15488, "depth": 7, "gates": 180224,
         "k": [14, 15, 15, 15, 15, 14, 14, 14],
         "wiring_sha256": "4fe75028c3a08a397e40331a06c9e18e67cfedbfe013b8adb8d0e020d0da2d1c"}


@pytest.fixture(scope="module")
def small_circuit():
    return M.circuit(SMALL, rng(2**31 + 5, 0))


def test_the_cells_configuration_is_pinned(bench):
    cell, entry = H.cell_of(bench, WORKLOAD)
    cfg = H.load_json(H.ROOT / entry["file"])
    assert cell["traffic"] == "prove" and cell["chips"] == 1
    assert cfg["generator"] == "mimc_agg" and cfg["example"] == "mimc"
    assert cfg["reduced"] == entry["reduced"] == []
    assert (cfg["constraints"], cfg["depth"], cfg["gates"]) == (140891, 17, 4718592)
    assert cfg["k"] == [18, 19] + [18] * 16


def test_the_compile_is_the_aggregators(small_circuit):
    """The generator's circuit and input table are `compile_round_native`'s
    for the same round 1."""
    from gkr_tpu_torch.recursion.native import compile_round_native

    g = rng(2**31 + 6, 1, 0)
    w = M.witness(small_circuit, g)
    circuits, ws = compile_round_native(M._round1("square_chain", rng(2**31 + 6, 1, 0)), 1)
    (circ,), (want,) = circuits, ws
    assert [(layer.add_gates, layer.mult_gates) for layer in circ.layers] == [
        (gate_tuples(a), gate_tuples(m)) for _, _, a, m in small_circuit["layers"]]
    assert circ.input_k == small_circuit["input_k"]
    assert w == want and not any(w[0])


def test_two_witnesses_share_one_wiring(small_circuit):
    """Round 1 compiled from two other draws has the same wiring digest,
    and each witness fills the one input map to a zero output table."""
    other = M.circuit(SMALL, rng(7, 0))
    assert M.wiring_sha256(other["layers"]) == M.wiring_sha256(small_circuit["layers"])
    def exprs(circ):
        return [node.expr for node in circ["inputs"]]

    assert exprs(other) == exprs(small_circuit)
    ws = [M.witness(small_circuit, rng(7, 1, j)) for j in range(2)]
    assert ws[0][-1] != ws[1][-1]
    assert not any(ws[0][0]) and not any(ws[1][0])


@pytest.mark.parametrize("pin,value", [("constraints", 15487), ("depth", 8),
                                       ("gates", 180225), ("k", [14] * 8),
                                       ("wiring_sha256", "0" * 64)])
def test_a_wrong_pin_raises(pin, value):
    with pytest.raises(ValueError, match=pin):
        M.circuit({**SMALL, pin: value}, rng(2**31 + 5, 0))


def test_a_tampered_input_value_fails_the_zero_output(small_circuit):
    """An input entry moved to another wire leaves a constraint's residual
    nonzero: the witness raises."""
    from gkr_tpu_torch.frontend.compiler import Node

    inputs = list(small_circuit["inputs"])
    i = next(i for i, n in enumerate(inputs) if n.expr[0] == "var" and n.expr[1] > 1)
    inputs[i] = Node("val", expr=("var", inputs[i].expr[1] - 1))
    with pytest.raises(AssertionError, match="not zero"):
        M.witness({**small_circuit, "inputs": inputs}, rng(2**31 + 6, 1, 0))


def test_the_cell_is_correct_and_the_control_is_not(bench):
    out = H.run_cell(bench, WORKLOAD, 2**31 + 99, 0.05, False, device="cpu",
                     config=SMALL, control_rounds=CONTROL_ROUNDS)
    assert out["correct"] is True
    assert out["checks"]["mismatched_elements"]["value"] == 0
    assert out["checks"]["unanswered"]["value"] == 0
    assert out["control"]["mismatched_elements"] > 0
    assert set(out["metrics"]) == {"prove_gates_per_s", "setup_s"}


def _run(kind, requests=(), launches=None, trace=True):
    return H.Run(kind=kind, requests=list(requests), window=(0.0, 1.0), setup_s=0.0,
                 spans=Spans(False), launches=launches or {},
                 trace={"busy_s": 1.0, "window_s": 2.0} if trace else None, shape={})


@pytest.fixture
def registry():
    from gkr_tpu_torch import tracing
    tracing.reset()
    tracing.enable()
    yield tracing
    tracing.disable()
    tracing.reset()


def test_walk_span_readers(registry):
    """Two walks of three layers: each reader gives its spans' seconds over
    the two walks, in ms."""
    for _ in range(2):
        with registry.span("walk"):
            with registry.span("walk.pass1"):
                for _ in range(3):
                    with registry.span("walk.mobius"):
                        time.sleep(0.001)
            with registry.span("walk.enqueue"):
                for _ in range(3):
                    with registry.span("walk.line"):
                        time.sleep(0.002)
    registry.disable()
    evs = registry.events()
    for metric, name in (("walk_mobius_ms", "walk.mobius"), ("walk_line_ms", "walk.line")):
        want = sum(e.end_ns - e.start_ns for e in evs if e.name == name) / 1e6 / 2
        got = H.load_metric(metric).read(_run("proofs"))
        assert got == pytest.approx(want) and got > 0
        assert H.load_metric(metric).read(_run("proofs", trace=False)) is None
        assert H.load_metric(metric).read(_run("layer_claims")) is None


def test_walk_span_readers_need_the_spans(registry):
    """A registry without `walk.mobius` and `walk.line` (a program before
    them) gives nothing."""
    with registry.span("walk"):
        pass
    for metric in ("walk_mobius_ms", "walk_line_ms"):
        assert H.load_metric(metric).read(_run("proofs")) is None


def test_launches_per_proof():
    done = [H.Request(0.0, 1, answer=object(), end=1.0) for _ in range(2)]
    failed = H.Request(0.0, 1, end=1.0, error="RuntimeError()")
    launches = {"round_tail": 20, "fold": 9, "mimc_multi": 1}
    read = H.load_metric("launches_per_proof").read
    assert read(_run("proofs", [*done, failed], launches)) == 15.0
    assert read(_run("proofs", [*done, failed], launches, trace=False)) is None
    assert read(_run("layer_claims", done, launches)) is None
    assert read(_run("proofs", [failed], launches)) is None


@pytest.mark.card
@pytest.mark.parametrize("seed", [2**31 + 1001, 2**31 + 1002, 2**31 + 1003])
def test_control_fails_at_the_cells_size(card, bench, seed):
    out = H.run_cell(bench, WORKLOAD, seed, 2.0, False, control_rounds=CONTROL_ROUNDS)
    print(json.dumps({"workload": WORKLOAD, "seed": seed, "program": out["checks"],
                      "control": out["control"], "attempted": out["attempted"]}))
    assert out["correct"] is True
    assert out["control"]["mismatched_elements"] > 0

