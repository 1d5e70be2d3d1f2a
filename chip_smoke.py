#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gkr_tpu_torch) on one NVIDIA card.

Run from the root of the repository:  python3 chip_smoke.py

Phases, each fatal on failure:
  1. card: name, power limit, SM clock, device count;
  2. build: the CUDA kernels from gkr_tpu_torch/csrc with nvcc (sm_90a);
  3. kernels: each kernel against its plain PyTorch version on the card at
     the per-round engine's shapes (n = 2^20), random and edge inputs,
     bit-equal; kernel and plain version timed with CUDA events;
  4. slice: prove(synth_circuit(20, 16)) with TorchBackend() on the card,
     per-stage times, the port's verify, and the kernel launch counts of
     that one prove; then device time by kernel over one more prove
     (torch.profiler);
  5. card against CPU: synth_circuit(12, 10) proved on both, identical;
  6. one JSON line of every kernel with its launches, time and bound.
The last line is {"ok": true, "device": {...}}; any failure exits non-zero
before it.  Imports nothing of jax or gkr_tpu.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
IMAD_PER_SM_CLOCK = 64           # 32-bit integer multiply-adds per SM per clock
IMAD_PER_PRODUCT = 264           # fr.cuh CIOS: 128 32x32->64 products x 2 + 8
ELEM_BYTES = 64                  # one field element: 16 int32 limbs
N = 1 << 20                      # the main path's table size
DEVICE = "cuda"

EXPECTED_LAUNCHES = {"phase1_eval": 20, "phase2_eval": 20, "fold": 40}


def smi(fields: str, fmt: str = "csv,noheader") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", f"--format={fmt}"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def sync_time(fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn() on the current stream, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------ test inputs

def edge_values(P: int, R: int) -> list[int]:
    """Canonical limb patterns at the edges: 0, 1, p-1, R mod p, and
    16-bit limbs of 0xFFFF below p."""
    return [0, 1, P - 1, P - 2, R % P, (1 << 253) - 1, (1 << 240) - 1,
            P - (1 << 16)]


def random_limbs(rng, shape, device) -> torch.Tensor:
    """Uniform canonical limbs: top limb below p's (0x3064), so value < p."""
    a = rng.integers(0, 1 << 16, size=tuple(shape) + (16,), dtype=np.int32)
    a[..., 15] = rng.integers(0, 0x3064, size=shape, dtype=np.int32)
    return torch.from_numpy(a).to(device)


def with_edges(t: torch.Tensor, rows: list[int], L) -> torch.Tensor:
    """Write the edge values' limbs into the first rows of the flat table."""
    flat = t.reshape(-1, 16)
    e = torch.from_numpy(L.canonical_limbs(rows)).to(t.device)
    flat[:len(rows)] = e
    return t


def rand_field(rng, P: int) -> int:
    return int.from_bytes(rng.bytes(32), "little") % P


def max_abs_err(x: torch.Tensor, y: torch.Tensor) -> float:
    return float((x.to(torch.int64) - y.to(torch.int64)).abs().max().item())


# ------------------------------------------------------------ stage timer

def timed_backend(TorchBackend):
    class StageTimedBackend(TorchBackend):
        """TorchBackend whose prover-interface calls are timed on the host
        clock, each ending in a device synchronize."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.seconds: dict[str, float] = {}

        def _timed(self, name, fn, *a, **kw):
            out, dt = sync_time(lambda: fn(*a, **kw))
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            return out

        def mle_struct(self, *a, **kw):
            return self._timed("mle_struct (incl. pack)", super().mle_struct, *a, **kw)

        def layer_sumcheck(self, *a, **kw):
            return self._timed("layer_sumcheck", super().layer_sumcheck, *a, **kw)

        def restrict_to_line(self, *a, **kw):
            return self._timed("restrict_to_line", super().restrict_to_line, *a, **kw)

        def sparse_from_dense(self, *a, **kw):
            return self._timed("sparse_from_dense", super().sparse_from_dense, *a, **kw)

    return StageTimedBackend


# ------------------------------------------------------------------ phases

def phase_kernels(K, L, P, R, sm_clock_hz):
    """Each kernel against its plain version at the path's shapes."""
    rng = np.random.default_rng(2024)
    dev = DEVICE
    edges = edge_values(P, R)
    pairs = [(x, y) for x in edges for y in edges]
    imad_rate = 132 * IMAD_PER_SM_CLOCK * sm_clock_hz
    rows = []

    def bound(nbytes, products):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = products * IMAD_PER_PRODUCT / imad_rate * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    def record(name, replaces, got, want, ms, plain_ms, nbytes, products):
        err = max_abs_err(got, want)
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version (max abs limb error {err})")
        b_ms, b_by = bound(nbytes, products)
        rows.append({"name": name, "route": "cuda",
                     "source": "gkr_tpu_torch/csrc/kernels.cu",
                     "replaces": replaces, "launches": 0,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        print(f"  {name:12s} bit-equal  kernel {ms:.4f} ms  plain {plain_ms:.2f} ms  "
              f"bound {b_ms:.4f} ms ({b_by})", flush=True)

    # mont_mul at 2^20, every pair of edge values in the first rows
    a = with_edges(random_limbs(rng, (N,), dev), [x for x, _ in pairs], L)
    b = with_edges(random_limbs(rng, (N,), dev), [y for _, y in pairs], L)
    got = K.mont_mul(a, b)
    want = K.mont_mul_plain(a, b)
    torch.cuda.synchronize()
    r_inv = pow(R, P - 2, P)
    host = L.unpack(got[:len(pairs)], montgomery=False)
    if host != [x * y * r_inv % P for x, y in pairs]:
        raise AssertionError("mont_mul: edge products differ from host ints")
    for nb in (1, 16):       # one scalar (pack, eq tables), one row per run
        if not torch.equal(K.mont_mul(a, b[:nb]), K.mont_mul_plain(a, b[:nb])):
            raise AssertionError(f"mont_mul: disagrees with {nb} b row(s)")
    record("mont_mul", "gkr_tpu/jaxeng/pallas_kernels.py:157", got, want,
           event_ms(lambda: K.mont_mul(a, b), 50),
           event_ms(lambda: K.mont_mul_plain(a, b), 2, 1),
           3 * N * ELEM_BYTES, N)
    del a, b, got, want

    # fold on the (2^20, 4) and (2^20, 3) stacks, random and edge challenges
    for T in (4, 3):
        S = with_edges(random_limbs(rng, (N, T), dev), edges, L)
        S.reshape(-1, 16)[N * T // 2:N * T // 2 + len(edges)] = \
            S.reshape(-1, 16)[:len(edges)].flip(0)
        for r_int in (rand_field(rng, P), P - 1, 0, R % P):
            r = L.pack_scalar(r_int, dev)
            got = K.fold(S, r)
            want = K.fold_plain(S, r)
            if not torch.equal(got, want):
                raise AssertionError(f"fold T={T}: disagrees at r={r_int}")
        if T == 4:      # the first phase-1 round's shape
            record("fold", "gkr_tpu/jaxeng/pallas_kernels.py:251", got, want,
                   event_ms(lambda: K.fold(S, r), 30),
                   event_ms(lambda: K.fold_plain(S, r), 2, 1),
                   (N * T + N // 2 * T) * ELEM_BYTES, N // 2 * T)
        else:
            print(f"  fold (2^20, 3) stack bit-equal  kernel "
                  f"{event_ms(lambda: K.fold(S, r), 30):.4f} ms", flush=True)
        del S, got, want

    # phase-1 and phase-2 evaluations at n = 2^20
    S1 = with_edges(random_limbs(rng, (N, 4), dev), edges * 4, L)
    got = K.phase1_eval(S1)
    want = K.phase1_eval_plain(S1)
    record("phase1_eval", "gkr_tpu/jaxeng/pallas_kernels.py:318", got, want,
           event_ms(lambda: K.phase1_partials(S1), 30),
           event_ms(lambda: K.phase1_eval_plain(S1), 2, 1),
           N * 4 * ELEM_BYTES, 3 * (N // 2))
    print(f"  phase1_eval with its second pass (sum_mod): "
          f"{event_ms(lambda: K.phase1_eval(S1), 10):.4f} ms", flush=True)
    del S1
    S2 = with_edges(random_limbs(rng, (N, 3), dev), edges * 3, L)
    for wb_int in (rand_field(rng, P), P - 1, 0):
        wb = L.pack_scalar(wb_int, dev)
        got = K.phase2_eval(S2, wb)
        want = K.phase2_eval_plain(S2, wb)
        if not torch.equal(got, want):
            raise AssertionError(f"phase2_eval: disagrees at wb={wb_int}")
    record("phase2_eval", "gkr_tpu/jaxeng/pallas_kernels.py:368", got, want,
           event_ms(lambda: K.phase2_partials(S2, wb), 30),
           event_ms(lambda: K.phase2_eval_plain(S2, wb), 2, 1),
           N * 3 * ELEM_BYTES + ELEM_BYTES, 6 * (N // 2))
    print(f"  phase2_eval with its second pass (sum_mod): "
          f"{event_ms(lambda: K.phase2_eval(S2, wb), 10):.4f} ms", flush=True)
    del S2
    torch.cuda.synchronize()
    return rows


def phase_slice(K, L, prove, verify, TorchBackend, synth_circuit):
    t0 = time.perf_counter()
    circuit, inputs = synth_circuit(20, 16)
    print(f"  host: generate synth_circuit(20, 16): {time.perf_counter() - t0:.3f} s",
          flush=True)
    t0 = time.perf_counter()
    w = circuit.evaluate(inputs)
    print(f"  host: evaluate: {time.perf_counter() - t0:.3f} s", flush=True)
    t0 = time.perf_counter()
    for i in range(1, len(w)):
        L.canonical_limbs(w[i])
    print(f"  host: pack bytes join of the {len(w) - 1} device tables: "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    backend = timed_backend(TorchBackend)()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    proof, dt = sync_time(lambda: prove(circuit, w, backend=backend))
    launches = dict(K.LAUNCHES)
    print(f"  prove (device stages, host clock with sync): {dt:.3f} s", flush=True)
    for name, s in backend.seconds.items():
        print(f"    {name}: {s:.3f} s", flush=True)
    print(f"  launches in this prove: {launches}", flush=True)
    print(f"  torch.cuda.max_memory_allocated: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    t0 = time.perf_counter()
    ok = verify(proof, circuit)
    print(f"  host: verify (port verifier, pure Python): "
          f"{time.perf_counter() - t0:.3f} s -> {ok}", flush=True)
    if not ok:
        raise AssertionError("the port's verifier rejected the 2^20 proof")
    for name, want in EXPECTED_LAUNCHES.items():
        if launches[name] != want:
            raise AssertionError(f"{name}: {launches[name]} launches, expected {want}")
    if launches["mont_mul"] <= 0:
        raise AssertionError("mont_mul was not launched on the main path")
    return launches, circuit, w, dt


def phase_profile(prove, TorchBackend, circuit, w, wall_s):
    """Device time by kernel over one more prove, under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, prof_wall = sync_time(lambda: prove(circuit, w, backend=TorchBackend()))

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    from torch.autograd import DeviceType

    # device-side events only: kernels and copies, not the CPU ops that
    # launched them nor the GPU ranges of the sumcheck.* spans
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == DeviceType.CUDA
              and dev_us(e) > 0 and not e.key.startswith("sumcheck.")]
    total_s = sum(dev_us(e) for e in events) / 1e6
    if total_s == 0:
        print("  profiler: no device time recorded (busy share not measured)",
              flush=True)
        return
    print(f"  device busy {total_s:.3f} s: {100 * total_s / wall_s:.1f}% of the "
          f"unprofiled prove's {wall_s:.3f} s ({prof_wall:.3f} s with the "
          f"profiler on)", flush=True)
    for e in sorted(events, key=dev_us, reverse=True)[:12]:
        print(f"    {dev_us(e) / 1e3:9.3f} ms  {e.count:6d} x  {e.key[:70]}",
              flush=True)
    print("  layer sumcheck stages (host clock, all layers, profiler on):",
          flush=True)
    for e in prof.key_averages():
        if (e.key.startswith("sumcheck.")
                and getattr(e, "device_type", None) == DeviceType.CPU):
            print(f"    {e.cpu_time_total / 1e3:9.3f} ms  {e.count:3d} x  {e.key}",
                  flush=True)


def phase_card_vs_cpu(prove, verify, TorchBackend, synth_circuit):
    circuit, inputs = synth_circuit(12, 10)
    w = circuit.evaluate(inputs)
    p_gpu, dt_gpu = sync_time(lambda: prove(
        circuit, w, backend=TorchBackend(tail_threshold=1 << 8)))
    t0 = time.perf_counter()
    p_cpu = prove(circuit, w, backend=TorchBackend(device="cpu",
                                                   tail_threshold=1 << 8))
    dt_cpu = time.perf_counter() - t0
    if p_gpu != p_cpu:
        raise AssertionError("k=12 proof on the card differs from the CPU's")
    if not verify(p_gpu, circuit):
        raise AssertionError("the port's verifier rejected the k=12 proof")
    print(f"  synth_circuit(12, 10), tail 2^8: card proof == CPU proof "
          f"(card {dt_gpu:.3f} s, CPU {dt_cpu:.3f} s), verified", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from gkr_tpu_torch import TorchBackend, prove, verify
    from gkr_tpu_torch.circuit import synth_circuit
    from gkr_tpu_torch.field import P, R
    from gkr_tpu_torch.torcheng import kernels as K
    from gkr_tpu_torch.torcheng import limbs as L

    name_power = smi("name,power.limit")
    sm_clock_hz = float(smi("clocks.max.sm", "csv,noheader,nounits")) * 1e6
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"[1] card: {name_power}; max SM clock {sm_clock_hz / 1e6:.0f} MHz; "
          f"torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"{kind} x {count}", flush=True)

    print("[2] build", flush=True)
    t0 = time.perf_counter()
    path = K.build()
    print(f"  {path.name}: {time.perf_counter() - t0:.2f} s", flush=True)
    for line in K.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas: " + line.strip(), flush=True)

    print("[3] kernels against their plain versions (n = 2^20; tolerance: "
          "bit-exact, max abs limb error 0)", flush=True)
    rows = phase_kernels(K, L, P, R, sm_clock_hz)

    print("[4] slice: prove(synth_circuit(20, 16), TorchBackend())", flush=True)
    launches, circuit, w, wall_s = phase_slice(K, L, prove, verify,
                                               TorchBackend, synth_circuit)

    print("[4b] where the prove's device time goes (torch.profiler)", flush=True)
    phase_profile(prove, TorchBackend, circuit, w, wall_s)
    del circuit, w

    print("[5] card against CPU", flush=True)
    phase_card_vs_cpu(prove, verify, TorchBackend, synth_circuit)

    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(name_power)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
