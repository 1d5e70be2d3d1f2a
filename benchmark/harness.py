"""The benchmark of the PyTorch/CUDA GKR prover (`gkr_tpu_torch`).

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

One run is one cell of `BENCHMARK.json` (a configuration under a traffic
mix) in a fresh process:

  1. set-up: the program's kernel libraries are built into its
     `_build/` in the checkout (only a checkout's first run builds; the
     result line's "build" gives their seconds, which set-up holds); the
     configuration's generator (`generators/<name>.py`, named in the
     configuration's file) makes the circuit and witnesses from the seed;
     the traffic's driver (`drivers/<name>.py`, named in
     `traffic/<mix>.json`) hands them to the program and warms up the
     cell's own shapes;
  2. the window: the driver serves requests for `--seconds`, the last
     request it started running to its end; with `--trace 1` under
     torch.profiler, with the benchmark's spans;
  3. the check: the device's memory peak is read, the program's state is
     freed, and the plain reference (`reference/`) re-proves a sample of
     the window's answers drawn from the seed (the traffic's `sample`);
     every element must agree;
  4. the result: each metric of the cell (`metrics/<name>.py`: the
     end-to-end ones, or with `--trace 1` the per-layer ones) and one JSON
     line, the last of standard output.

A run exits non-zero, with no result, without a CUDA card or with fewer
cards than the cell asks for, and if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gkr_tpu")


@dataclass
class Request:
    """One request of the window: a layer claim or a proof."""
    start: float
    gates: int
    point: list | None = None
    witness: int = 0
    end: float | None = None
    answer: object = None
    error: str | None = None

    def fail(self, exc: BaseException) -> None:
        self.error = repr(exc)
        self.end = time.perf_counter()

    @property
    def ok(self) -> bool:
        return self.error is None and self.answer is not None


@dataclass
class Run:
    """What the metric readers read."""
    kind: str                      # the traffic's kind: layer_claims, proofs
    requests: list
    window: tuple[float, float]    # host clock, the window's start and end
    setup_s: float
    spans: object                  # spans.Spans
    launches: dict                 # the program's kernel launches in the window
    trace: dict | None             # trace.summarize of the traced window
    shape: dict                    # the traffic's request shape (counts' input)


def process_started() -> float:
    """When this process started, on the `time.perf_counter` clock."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        ticks = int(fields[19])                       # field 22: starttime
        since = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - since
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


T_PROCESS = process_started()


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_metric(name: str):
    """The reader of metric `name`: `metrics/<name>.py`, or else the reader
    of the name's part before its first dot (`device_idle_pct.layer` and
    `device_idle_pct.prove` share `metrics/device_idle_pct.py`)."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (`gkr_tpu_torch` is not `gkr_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cell_of(bench: dict, workload: str):
    """(the workload's entry, its configuration's entry) in BENCHMARK.json."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return cell, cfg


def _card(chips: int) -> str:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell asks for {chips} cards, "
                         f"{torch.cuda.device_count()} visible")
    return "cuda"


def build_kernels() -> dict:
    """Build the program's CUDA and host libraries into its checkout's
    `_build/`, unless a run there has already built them: the part of
    set-up that only the first run of a checkout pays."""
    from gkr_tpu_torch import native
    from gkr_tpu_torch.torcheng import kernels as K

    built = not (K.library_path().exists() and native.library_path().exists())
    t = time.perf_counter()
    K.build()
    native.build()
    return {"seconds": time.perf_counter() - t, "built": built}


def _selected(entries, workload):
    return [m for m in entries if "workloads" not in m or workload in m["workloads"]]


def _judge(driver, device, sample, control_rounds=None) -> dict:
    """Checks `sample` against the reference by the traffic's own `check`; with
    `control_rounds`, checks the control (the reference hashing with that many
    MiMC7 rounds) in the program's place.  An answer the comparison cannot
    read counts as one mismatch."""
    from .reference.gkr import Reference

    control = None if control_rounds is None else Reference(device, control_rounds)
    try:
        return driver.check(Reference(device), sample, control=control)
    except Exception as exc:        # an answer the comparison cannot read
        print(f"check failed: {exc!r}", file=sys.stderr)
        return {"compared": 0, "mismatched": 1}


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
             device: str | None = None, config: dict | None = None,
             control_rounds: int | None = None) -> dict:
    """One run of a cell -> the result line's object.  `device` None means
    the card (and its check); `config` replaces the configuration's file
    (the tests' small shapes); `control_rounds` adds the control's
    judgement of the same sample under the key "control" (the tests')."""
    import torch

    from .generators.common import rng
    from .reference.compare import LIMITS
    from .spans import Spans

    cell, cfg_entry = cell_of(bench, workload)
    if device is None:
        device = _card(int(cell["chips"]))
    cfg = config if config is not None else load_json(ROOT / cfg_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    generator = importlib.import_module(f"benchmark.generators.{cfg['generator']}")
    drivers = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    spans = Spans(trace)
    build = build_kernels() if device != "cpu" else None
    driver = drivers.Driver(cfg, traffic, generator, seed, device, spans)
    driver.setup()
    setup_s = time.perf_counter() - T_PROCESS
    spans.seconds.clear()                 # the warm-up's spans are set-up's

    from gkr_tpu_torch.torcheng import kernels as K

    tracer = None
    if trace:
        from .trace import DeviceTrace
        tracer = DeviceTrace()
        tracer.start()
    K.reset_launches()
    t0 = time.perf_counter()
    with spans.marker("window"):
        driver.window(t0 + seconds)
    reqs = driver.requests
    t1 = max((r.end for r in reqs), default=time.perf_counter())
    t_read = time.perf_counter()
    summary = tracer.stop() if tracer is not None else None
    t_read = time.perf_counter() - t_read
    launches = dict(K.LAUNCHES)
    cuda = device != "cpu"
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    # the check, with the program's state freed
    driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    sample = driver.sample(rng(seed, 9), int(traffic["check_sample"]))
    t_check = time.perf_counter()
    chk = _judge(driver, device, sample)
    t_check = time.perf_counter() - t_check
    unanswered = sum(not r.ok for r in reqs)
    checks = {"mismatched_elements": {"value": chk["mismatched"],
                                      "limit": LIMITS["mismatched_elements"]},
              "unanswered": {"value": unanswered, "limit": LIMITS["unanswered"]}}
    correct = (bool(sample) and chk["compared"] > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))

    run = Run(driver.kind, reqs, (t0, t1), setup_s, spans, launches, summary,
              driver.shape)
    metrics = {}
    for m in _selected(bench["per_layer" if trace else "end_to_end"], workload):
        value = load_metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": len(reqs),
           "failed": sum(r.error is not None for r in reqs),
           "metrics": metrics, "device": dev}
    if build is not None:
        out["build"] = build
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    if build is not None:
        print(f"set-up {setup_s:.3f} s holds {build['seconds']:.3f} s of the "
              f"kernel libraries, {'built anew' if build['built'] else 'found built'}"
              f" in the checkout", file=sys.stderr)
    print(f"window: {len(reqs)} requests in {t1 - t0:.3f} s; set-up "
          f"{setup_s:.3f} s; trace read-back {t_read:.3f} s; reference "
          f"check {t_check:.3f} s", file=sys.stderr)
    lat = sorted(r.end - r.start for r in reqs)
    if lat:
        print(f"latency s: min {lat[0]:.4f} median {lat[len(lat) // 2]:.4f} max "
              f"{lat[-1]:.4f}; in order: "
              + " ".join(f"{r.end - r.start:.3f}" for r in reqs[:40]), file=sys.stderr)
    errors = sorted({r.error for r in reqs if r.error})
    for e in errors[:5]:
        print(f"request failed: {e}", file=sys.stderr)
    print(f"checked {len(sample)} of {len(reqs)} requests, "
          f"{chk['compared']} elements against the reference", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    if control_rounds is not None:
        ctl = _judge(driver, device, sample, control_rounds)
        out["control"] = {"mismatched_elements": ctl["mismatched"],
                          "compared": ctl["compared"]}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"modules that must not load were loaded: {found}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
