"""The harness on the CPU at small shapes: the result line, the modules it
loads, the run without a card, the trace's reduction, and `correct`
falling to false under each fault the cells can have."""

import json
import subprocess
import sys

import pytest

from benchmark import harness as H
from benchmark.conftest import ROOT, small_config
from benchmark.trace import summarize

SEED = 2**31 + 4242
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
# (cell, configuration at a small shape): the cells of BENCHMARK.json, and
# the proofs' traffic over the matrix-product circuit's uneven layers
CELLS = [("synth20.layer", "synth20"), ("synth20.prove", "synth20"),
         ("synth20.prove", "matmul")]


def _run(bench, workload, config, seconds=0.05, **kw):
    return H.run_cell(bench, workload, SEED, seconds, False, device="cpu",
                      config=small_config(config), **kw)


@pytest.mark.parametrize("workload,config", CELLS)
def test_result_line_and_correct(bench, workload, config):
    out = _run(bench, workload, config)
    assert list(out) == KEYS
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    want = {m["name"] for m in bench["end_to_end"]
            if "workloads" not in m or workload in m["workloads"]}
    assert set(out["metrics"]) == want
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert out["checks"] == {"mismatched_elements": {"value": 0, "limit": 0},
                             "unanswered": {"value": 0, "limit": 0}}
    json.dumps(out)


def test_every_cells_metrics_have_readers(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert hasattr(H.load_metric(m["name"]), "read"), m["name"]
    for w in bench["workloads"]:
        cell, cfg = H.cell_of(bench, w["name"])
        assert (ROOT / cfg["file"]).exists()
        assert (ROOT / "benchmark" / "traffic" / f"{cell['traffic']}.json").exists()


def test_forbidden_modules_compare_whole_names(monkeypatch):
    assert "gkr_tpu" not in H.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gkr_tpu_torch_x", sys)
    assert H.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gkr_tpu", sys)
    assert H.forbidden_modules() == ["gkr_tpu"]


def test_a_run_loads_no_jax_nor_the_jax_package():
    code = ("import sys, json; sys.path.insert(0, %r)\n"
            "from benchmark import harness as H\n"
            "from benchmark.conftest import small_config\n"
            "b = H.load_json(H.ROOT / 'BENCHMARK.json')\n"
            "H.run_cell(b, 'synth20.layer', 5, 0.01, False, device='cpu',"
            " config=small_config('synth20'))\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
            % str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    top = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert "gkr_tpu_torch" in top
    assert not top & set(H.FORBIDDEN)


def test_without_a_card_the_run_fails_and_prints_nothing(tmp_path):
    """On this CPU-only machine the command exits non-zero, stdout empty."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "synth20.layer", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert res.returncode != 0 and res.stdout == ""


def test_trace_reduction():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 100, "dur": 1000},
          {"ph": "X", "cat": "user_annotation", "name": "bench.host_check", "ts": 500, "dur": 200},
          {"ph": "X", "cat": "user_annotation", "name": "fused.build_phase1", "ts": 120, "dur": 50},
          {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 90, "dur": 40},
          {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 125, "dur": 100},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 200, "dur": 100},
          {"ph": "X", "cat": "gpu_user_annotation", "name": "fused.x", "ts": 300, "dur": 700},
          {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 800, "dur": 100}]
    s = summarize(ev)
    assert s["busy_s"] == pytest.approx(300e-6) and s["window_s"] == pytest.approx(1e-3)
    assert s["device_ops"][0] == ["k_a", pytest.approx(130e-6)]
    assert dict(s["idle_gaps"]) == {"bench.host_check": pytest.approx(500e-6),
                                    "host, outside any span": pytest.approx(200e-6)}
    with pytest.raises(RuntimeError):
        summarize(ev[1:])


# -- faults planted in the timed path: each must make `correct` false --------

def _fold_unchanged(monkeypatch):
    """A step that returns its state unchanged: the round's fold."""
    from gkr_tpu_torch.torcheng import fused
    monkeypatch.setattr(fused.K, "fold", lambda S, r: S)


def _half_batch(monkeypatch):
    """Half of the batch left out: the second half of the arrays a download
    returns replaced by the first half's (a batch of claims), the second
    half of every table the prover packs replaced by zeros (a proof)."""
    from gkr_tpu_torch.torcheng import fused
    from gkr_tpu_torch.torcheng.backend import TorchBackend
    real = fused.download
    real_packed = TorchBackend.packed

    def packed(self, layer_idx, w_values):
        t = real_packed(self, layer_idx, w_values).clone()
        t[t.shape[0] // 2:] = 0
        return t
    monkeypatch.setattr(TorchBackend, "packed", packed)

    def download(arrays):
        host = list(real(arrays))
        h = len(host) // 2
        for i in range(h, 2 * h):
            if host[i].shape == host[i - h].shape:
                host[i] = host[i - h].clone()
        return tuple(host)
    monkeypatch.setattr(fused, "download", download)


def _answer_altered(monkeypatch):
    """An answer altered where it is produced: the first coefficient of a
    layer's proof (claims), the first of each q (proofs)."""
    from gkr_tpu_torch.torcheng import backend, fused
    real = fused.check_transcript

    def check_transcript(*a):
        proof, chal = real(*a)
        proof[0][0] = (proof[0][0] + 1) % H_P
        return proof, chal
    monkeypatch.setattr(fused, "check_transcript", check_transcript)
    real_interp = backend.interpolate
    monkeypatch.setattr(backend, "interpolate",
                        lambda pts: [(c + 1) % H_P for c in real_interp(pts)])


H_P = 21888242871839275222246405745257275088548364400416034343698204186575808495617


@pytest.mark.parametrize("fault", [_fold_unchanged, _half_batch, _answer_altered])
@pytest.mark.parametrize("workload,config", CELLS)
def test_a_fault_in_the_timed_path_is_not_correct(bench, workload, config, fault,
                                                  monkeypatch):
    fault(monkeypatch)
    out = _run(bench, workload, config)
    assert out["correct"] is False, out["checks"]


def test_spans_sum_by_request():
    from benchmark.spans import Spans
    sp = Spans(True)
    for req, n in ((0, 2), (1, 1)):
        sp.request = req
        for _ in range(n):
            with sp.span("pack"):
                pass
    assert len(sp.per_request("pack")) == 2 and sp.per_request("other") == []
    assert Spans(False).per_request("pack") == []


def _fake_run(kind, lat, **kw):
    from benchmark.spans import Spans
    reqs = [H.Request(0.0, gates=1000, end=t, answer=1) for t in lat]
    base = dict(kind=kind, requests=reqs, window=(0.0, 2.0), setup_s=3.5,
                spans=Spans(False), launches={"fold": 40, "round_tail": 40},
                trace={"busy_s": 1.5, "window_s": 2.0},
                shape={"n": 1 << 20, "gates": 1 << 20, "k_cur": 4})
    base.update(kw)
    return H.Run(**base)


def test_metric_readers():
    from benchmark.counts.sumcheck import floor_s
    lat = [0.1 * (i + 1) for i in range(20)]
    run = _fake_run("layer_claims", lat)
    read = lambda name, r=run: H.load_metric(name).read(r)
    assert read("layer_gates_per_s") == 20 * 1000 / 2.0
    assert read("layer_p95_ms") == pytest.approx(1900.0)
    assert read("launches_per_claim") == 4.0
    assert read("device_idle_pct.layer") == pytest.approx(25.0)
    assert read("sumcheck_roofline") == pytest.approx(
        100 * floor_s(1 << 20, 1 << 20, 4)[0] * 20 / 1.5)
    assert read("sumcheck_roofline", _fake_run("layer_claims", lat, trace=None)) is None
    assert read("setup_s") == 3.5 and read("host_check_ms") is None
    assert read("prove_gates_per_s") is None
    prove = _fake_run("proofs", [1.0, 2.0], trace=None)
    assert read("prove_gates_per_s", prove) == 2 * 1000 / 2.0
    assert read("layer_gates_per_s", prove) is None
    assert read("device_idle_pct.prove", prove) is None


def test_metrics_of_one_quantity_share_a_reader(bench):
    """`device_idle_pct.layer` and `.prove` are one reader's, found by the
    name's part before its first dot."""
    for name in ("device_idle_pct.layer", "device_idle_pct.prove"):
        assert H.load_metric(name).__file__.endswith("metrics/device_idle_pct.py")
    assert H.load_metric("setup_s").__file__.endswith("metrics/setup_s.py")


def test_the_layer_sample_covers_every_slot_of_a_batch():
    """A fault at one position of a batch (one slice of the download) is in
    every sample: each slot gives one claim, drawn from the seed."""
    from benchmark.drivers.layer_claims import Driver
    from benchmark.generators.common import rng

    d = Driver.__new__(Driver)
    d.batch = 6
    d.requests = [H.Request(0.0, gates=1, answer=1) for _ in range(6 * 40)]
    d.requests[7].error = "raised"
    picks = [d.sample(rng(s, 9), 6) for s in range(20)]
    for pick in picks:
        assert sorted(i % 6 for i in pick) == list(range(6)) and 7 not in pick
    assert len({tuple(p) for p in picks}) > 1
    assert d.sample(rng(1, 9), 6) == d.sample(rng(1, 9), 6)
