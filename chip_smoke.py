#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gkr_tpu_torch) on one NVIDIA card.

Run from the root of the repository:  python3 chip_smoke.py

Phases, each fatal on failure:
  1. card: name, power limit, SM clock, device count;
  2. build: the CUDA kernels from gkr_tpu_torch/csrc with nvcc (sm_90a);
  3. kernels: each kernel against its plain PyTorch version on the card at
     the shapes of the path that runs it (n = 2^20; the wiring plans of
     synth_circuit(20, 16); a bucket of 70,000 gates), random and edge
     inputs, bit-equal; kernel and plain version timed with CUDA events,
     `index_add_` beside the segment sum, `torch.stack` beside the stack;
  4. per-round slice: prove(synth_circuit(20, 16)) with
     TorchBackend(fused=False), per-stage times, the port's verify, and the
     kernel launch counts of that one prove; then device time by kernel
     over one more prove (torch.profiler);
  5. fused slice: the same with TorchBackend(), the fused engine;
  6. card against CPU: synth_circuit(12, 10) proved on both with each
     engine, identical; a corrupted device challenge must make the fused
     layer's host check raise;
then one JSON line of every kernel with its launches, time and bound.
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

FUSED_ONLY = ("phase1_partials", "phase2_partials", "round_coeffs",
              "mimc_multi", "seg_sum", "normalize", "normalize_mul", "stack")
# Launches of one prove of synth_circuit(20, 16): three layer sumchecks with
# k_next = 20, 20, 16 (40 + 40 + 32 rounds) on the card.  Both engines build
# eq(z) over k_cur = 4, 20, 20 points and eq(b*) over 20, 20, 16, one
# eq_table launch per doubling.
EXPECTED_PER_ROUND = {"phase1_eval": 20, "phase2_eval": 20, "fold": 40,
                      "eq_table": 100, **{name: 0 for name in FUSED_ONLY}}
EXPECTED_FUSED = {
    "round_coeffs": 112, "mimc_multi": 112, "fold": 112,
    "phase1_partials": 56, "phase2_partials": 56,
    # 2 plans (phase 1, phase 2) per gate kind: 2 + 2 for each wide layer,
    # 1 + 1 for the output layer (add gates only)
    "seg_sum": 10,
    # HA1, HA2, HM, FA per wide layer; HA1, HA2, FA for the output layer
    "normalize": 11,
    "normalize_mul": 2,                 # FM * W~(b*), wide layers only
    "stack": 6,                         # one a build, two builds a layer
    "eq_table": 100,
    "phase1_eval": 0, "phase2_eval": 0,
}
LAUNCHES_FROM_PER_ROUND = ("phase1_eval", "phase2_eval")


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

    def bound(nbytes, products, serial=False):
        """Bytes at the memory rate against products at the card's IMAD
        rate, or, for one dependent chain (serial), at one thread's issue
        rate of one IMAD a clock."""
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        rate = sm_clock_hz if serial else imad_rate
        t_ops = products * IMAD_PER_PRODUCT / rate * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    def record(name, replaces, got, want, ms, plain_ms, nbytes, products,
               library_ms=None, serial=False):
        err = max_abs_err(got, want)
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version (max abs limb error {err})")
        b_ms, b_by = bound(nbytes, products, serial)
        rows.append({"name": name, "route": "cuda",
                     "source": "gkr_tpu_torch/csrc/kernels.cu",
                     "replaces": replaces, "launches": 0,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": library_ms})
        lib = "" if library_ms is None else f"  library {library_ms:.4f} ms"
        print(f"  {name:15s} bit-equal  kernel {ms:.4f} ms  plain {plain_ms:.2f} ms  "
              f"bound {b_ms:.4f} ms ({b_by}){lib}", flush=True)

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
    return rows, record, bound


def relaxed_edges(P: int, lin: int) -> list[list[int]]:
    """Relaxed limb columns at the contract's limits (lin limbs, each below
    2^31, value below p * 2^256): the low limbs near 2^31 under values up to
    p * 2^256 - 1, and, with 18 limbs, every limb at 2^31 - 1."""
    top = (P << 256) - 1
    values = [top, top - (1 << 255), (P - 1) << 256, P << 200,
              (1 << 288) - 1, P, 1, 0]
    near = [(1 << 31) - (1 << 16) - 1] * (lin - 2) + [0, 0]
    base = sum(b << (16 * i) for i, b in enumerate(near))
    cols = []
    for v in values:
        low, rest = (near, v - base) if v >= base else ([0] * lin, v)
        col = [b + ((rest >> (16 * i)) & 0xFFFF) for i, b in enumerate(low)]
        if sum(c << (16 * i) for i, c in enumerate(col)) == v:
            cols.append(col)            # v fits lin limbs
    if lin <= 18:
        cols.append([(1 << 31) - 1] * lin)
    return cols


def phase_fused_kernels(K, L, F, P, R, Mimc7, record, bound, circuit):
    """The fused engine's kernels against their plain versions, at the
    shapes synth_circuit(20, 16) gives them."""
    rng = np.random.default_rng(2025)
    dev = DEVICE
    edges = edge_values(P, R)

    # eq_table at k = 20, random and edge points
    z = random_limbs(rng, (20,), dev)
    zedge = with_edges(random_limbs(rng, (20,), dev), edges, L)
    for pt in (zedge, z):
        got, want = K.eq_table(pt), K.eq_table_plain(pt)
        if not torch.equal(got, want):
            raise AssertionError("eq_table: disagrees with its plain version")
    if L.unpack(K.eq_table(z[:3])) != L.unpack(K.eq_table_plain(z[:3])):
        raise AssertionError("eq_table: k = 3 table differs")
    record("eq_table", "gkr_tpu/jaxeng/pallas_kernels.py:214", got, want,
           event_ms(lambda: K.eq_table(z), 20),
           event_ms(lambda: K.eq_table_plain(z), 2, 1),
           (20 + N) * ELEM_BYTES, 2 * N - 2)
    del got, want

    # seg_sum on the 2^20 layer's plans and on a hot bucket of 70,000 gates
    layer = circuit.layers[1]
    wiring = F.build_wiring(layer.add_gates, layer.mult_gates, N, dev)
    G_hot = 1 << 17
    keys = np.sort(rng.integers(0, N, size=G_hot))
    keys[:70000] = 12345
    keys.sort()
    hot_hib = torch.from_numpy(np.searchsorted(keys, np.arange(N), side="right")
                               .astype(np.int32)).to(dev)
    p_limbs = torch.from_numpy(L.canonical_limbs([P - 1])).to(dev)
    first = None
    for label, hib, T in (("2^20 layer's phase-1 add plan, T = 2", wiring.a1.hib, 2),
                          ("2^20 layer's phase-1 mult plan, T = 1", wiring.m1.hib, 1),
                          ("hot bucket of 70,000 gates, T = 2", hot_hib, 2)):
        G = int(hib[-1])
        ws = [random_limbs(rng, (G,), dev) for _ in range(T)]
        for w in ws:
            w[::2] = p_limbs                      # largest limbs: carries
        got, want = K.seg_sum(ws, hib), K.seg_sum_plain(ws, hib)
        if not torch.equal(got, want):
            raise AssertionError(f"seg_sum ({label}): disagrees with its plain "
                                 f"version (max abs limb error {max_abs_err(got, want)})")
        counts = torch.diff(hib.to(torch.int64),
                            prepend=torch.zeros(1, dtype=torch.int64, device=dev))
        bucket = torch.repeat_interleave(torch.arange(N, device=dev), counts)
        w64 = [w.to(torch.int64) for w in ws]
        ms = event_ms(lambda: K.seg_sum(ws, hib), 20)
        plain_ms = event_ms(lambda: K.seg_sum_plain(ws, hib), 2, 1)
        lib_ms = event_ms(lambda: [torch.zeros((N, 16), dtype=torch.int64, device=dev)
                                   .index_add_(0, bucket, x) for x in w64], 10)
        nbytes = T * G * ELEM_BYTES + N * 4 + T * K.SEG_LIMBS * N * 4
        b_ms, b_by = bound(nbytes, 0)
        print(f"  seg_sum, {label}: max bucket {int(counts.max())} gates: bit-equal  "
              f"kernel {ms:.4f} ms  plain {plain_ms:.2f} ms  index_add_ {lib_ms:.4f} ms  "
              f"bound {b_ms:.4f} ms ({b_by})", flush=True)
        if first is None:
            first = (got, want, ms, plain_ms, nbytes, lib_ms)
    got, want, ms, plain_ms, nbytes, lib_ms = first
    record("seg_sum", "gkr_tpu/jaxeng/pallas_kernels.py:618", got, want, ms,
           plain_ms, nbytes, 0, library_ms=lib_ms)
    del got, want, first, ws, w64, bucket

    # normalize and normalize_mul at 2^20: the fused path's 18 limbs and the
    # contract's 32, limbs near 2^31 - 1, values near p * 2^256
    s_int = rand_field(rng, P)
    s = L.pack_scalar(s_int, dev)
    for lin in (32, 18):
        t = torch.from_numpy(rng.integers((1 << 31) - (1 << 20), 1 << 31,
                                          size=(lin, N)).astype(np.int32)).to(dev)
        if lin == 32:
            t[30:] = 0
        cols = relaxed_edges(P, lin)
        t[:, :len(cols)] = torch.tensor(cols, dtype=torch.int32, device=dev).T
        vals = [sum(c << (16 * i) for i, c in enumerate(col)) for col in cols]
        for scalar in (None, s):
            got, want = K.normalize(t, scalar), K.normalize_plain(t, scalar)
            if not torch.equal(got, want):
                raise AssertionError(f"normalize lin={lin} scalar={scalar is not None}: "
                                     f"disagrees with its plain version")
            host = L.unpack(got[:len(cols)], montgomery=False)
            mult = 1 if scalar is None else s_int
            if host != [v * mult % P for v in vals]:
                raise AssertionError(f"normalize lin={lin}: edge values differ "
                                     f"from host ints")
    record("normalize", "gkr_tpu/jaxeng/pallas_kernels.py:521",
           K.normalize(t), K.normalize_plain(t),
           event_ms(lambda: K.normalize(t), 30),
           event_ms(lambda: K.normalize_plain(t), 2, 1),
           18 * N * 4 + N * ELEM_BYTES, 1.5 * N)
    record("normalize_mul", "gkr_tpu/jaxeng/pallas_kernels.py:554", got, want,
           event_ms(lambda: K.normalize(t, s), 30),
           event_ms(lambda: K.normalize_plain(t, s), 2, 1),
           18 * N * 4 + N * ELEM_BYTES + ELEM_BYTES, 2.5 * N)
    del t, got, want

    # round_coeffs at G = 1024 (2^20 tables) and G = 1 (the last rounds)
    tiny = torch.zeros(16, dtype=torch.int32, device=dev)
    launch_ms = event_ms(lambda: tiny.add_(0), 200)
    for G in (1, 1024):
        part = with_edges(random_limbs(rng, (G, 3), dev), edges[:3 * G], L)
        got, want = K.round_coeffs(part), K.round_coeffs_plain(part)
        if not torch.equal(got, want):
            raise AssertionError(f"round_coeffs G={G}: disagrees with its plain version")
    record("round_coeffs", "gkr_tpu/jaxeng/pallas_kernels.py:479", got, want,
           event_ms(lambda: K.round_coeffs(part), 200),
           event_ms(lambda: K.round_coeffs_plain(part), 3, 1),
           (G * 3 + 3) * ELEM_BYTES, 0)
    print(f"    round_coeffs beside one tiny plain-torch launch back to back: "
          f"{launch_ms:.4f} ms", flush=True)

    # mimc_multi at lengths 2 and 3 against the plain version and the host
    host = Mimc7()
    for vals in ([0, 1], [P - 1, P - 1], [0, 1, P - 1], [P - 1, 0, 1],
                 [rand_field(rng, P) for _ in range(2)],
                 [rand_field(rng, P) for _ in range(3)]):
        x = L.pack(vals, dev)
        got, want = K.mimc_multi(x), K.mimc_multi_plain(x)
        if not torch.equal(got, want) or L.unpack_scalar(got) != host.multi_hash(vals, 0):
            raise AssertionError(f"mimc_multi: differs from the host Mimc7 on {vals}")
    ms = event_ms(lambda: K.mimc_multi(x), 50)
    record("mimc_multi", "gkr_tpu/jaxeng/pallas_kernels.py:813", got, want, ms,
           event_ms(lambda: K.mimc_multi_plain(x), 5, 1),
           (3 + K.MIMC_ROUNDS + 1) * ELEM_BYTES, 3 * 4 * K.MIMC_ROUNDS,
           serial=True)
    print(f"    mimc_multi, 3 elements: {3 * 4 * K.MIMC_ROUNDS} dependent products, "
          f"{ms / (3 * 4 * K.MIMC_ROUNDS) * 1e6:.1f} ns each; bound: one thread "
          f"issuing one IMAD a clock", flush=True)

    # stack: the phase-1 build's (2^20, 4) stack, the phase-2 build's
    # (2^20, 3) one, and the output layer's with no mult table (None)
    tabs = [with_edges(random_limbs(rng, (N,), dev), edges, L) for _ in range(4)]
    for tables in (tabs, tabs[:3], tabs[:3] + [None], [tabs[0], None, tabs[1]]):
        got, want = K.stack(tables), K.stack_plain(tables)
        if not torch.equal(got, want):
            raise AssertionError(f"stack T={len(tables)}: disagrees with its "
                                 f"plain version")
    got, want = K.stack(tabs), K.stack_plain(tabs)
    record("stack", "gkr_tpu/jaxeng/pallas_kernels.py:873", got, want,
           event_ms(lambda: K.stack(tabs), 30),
           event_ms(lambda: K.stack_plain(tabs), 10),
           2 * 4 * N * ELEM_BYTES, 0,
           library_ms=event_ms(lambda: torch.stack(tabs, dim=1), 10))
    del tabs, got, want

    # the partials entry points of the eval kernels, at n = 2^20 and n = 2
    for n in (2, N):
        S1 = with_edges(random_limbs(rng, (n, 4), dev), (edges * 4)[:4 * n], L)
        got, want = K.phase1_partials(S1), K.phase1_partials_plain(S1)
        if not torch.equal(got, want):
            raise AssertionError(f"phase1_partials n={n}: disagrees")
    record("phase1_partials", "gkr_tpu/jaxeng/pallas_kernels.py:406", got, want,
           event_ms(lambda: K.phase1_partials(S1), 30),
           event_ms(lambda: K.phase1_partials_plain(S1), 2, 1),
           N * 4 * ELEM_BYTES, 3 * (N // 2))
    del S1
    for n in (2, N):
        S2 = with_edges(random_limbs(rng, (n, 3), dev), (edges * 3)[:3 * n], L)
        got, want = K.phase2_partials(S2, s), K.phase2_partials_plain(S2, s)
        if not torch.equal(got, want):
            raise AssertionError(f"phase2_partials n={n}: disagrees")
    record("phase2_partials", "gkr_tpu/jaxeng/pallas_kernels.py:428", got, want,
           event_ms(lambda: K.phase2_partials(S2, s), 30),
           event_ms(lambda: K.phase2_partials_plain(S2, s), 2, 1),
           N * 3 * ELEM_BYTES + ELEM_BYTES, 6 * (N // 2))
    del S2
    torch.cuda.synchronize()


def phase_slice(K, prove, verify, backend, circuit, w, expected):
    """One prove with the launch counters reset just before and read just
    after; the port's verify; the counts against `expected`."""
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    proof, dt = sync_time(lambda: prove(circuit, w, backend=backend))
    launches = dict(K.LAUNCHES)
    print(f"  prove (device stages, host clock with sync): {dt:.3f} s", flush=True)
    for name, sec in backend.seconds.items():
        print(f"    {name}: {sec:.3f} s", flush=True)
    print(f"  launches in this prove: {launches}", flush=True)
    print(f"  torch.cuda.max_memory_allocated: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    t0 = time.perf_counter()
    ok = verify(proof, circuit)
    print(f"  host: verify (port verifier, pure Python): "
          f"{time.perf_counter() - t0:.3f} s -> {ok}", flush=True)
    if not ok:
        raise AssertionError("the port's verifier rejected the 2^20 proof")
    for name, want in expected.items():
        if launches[name] != want:
            raise AssertionError(f"{name}: {launches[name]} launches, expected {want}")
    if launches["mont_mul"] <= 0:
        raise AssertionError("mont_mul was not launched on the main path")
    return launches, proof, dt


def phase_profile(prove, make_backend, circuit, w, wall_s):
    """Device time by kernel over one more prove, under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    spans = ("sumcheck.", "fused.")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, prof_wall = sync_time(lambda: prove(circuit, w, backend=make_backend()))

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    from torch.autograd import DeviceType

    # device-side events only: kernels and copies, not the CPU ops that
    # launched them nor the GPU ranges of the layer engines' spans
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == DeviceType.CUDA
              and dev_us(e) > 0 and not e.key.startswith(spans)]
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
        if (e.key.startswith(spans)
                and getattr(e, "device_type", None) == DeviceType.CPU):
            print(f"    {e.cpu_time_total / 1e3:9.3f} ms  {e.count:3d} x  {e.key}",
                  flush=True)


def phase_card_vs_cpu(F, prove, verify, TorchBackend, synth_circuit, mle_struct,
                      prove_layer_sumcheck, Mimc7, P):
    circuit, inputs = synth_circuit(12, 10)
    w = circuit.evaluate(inputs)
    for label, kw in (("per-round engine, tail 2^8",
                       dict(fused=False, tail_threshold=1 << 8)),
                      ("fused engine", {})):
        p_gpu, dt_gpu = sync_time(lambda: prove(circuit, w,
                                                backend=TorchBackend(**kw)))
        t0 = time.perf_counter()
        p_cpu = prove(circuit, w, backend=TorchBackend(device="cpu", **kw))
        dt_cpu = time.perf_counter() - t0
        if p_gpu != p_cpu:
            raise AssertionError(f"k=12 proof on the card differs from the CPU's "
                                 f"({label})")
        if not verify(p_gpu, circuit):
            raise AssertionError(f"the port's verifier rejected the k=12 proof ({label})")
        print(f"  synth_circuit(12, 10), {label}: card proof == CPU proof "
              f"(card {dt_gpu:.3f} s, CPU {dt_cpu:.3f} s), verified", flush=True)

    # one fused layer, deferred: its transcript against the host engine's,
    # then a corrupted device challenge must fail the host check
    layer = circuit.layers[1]
    rng = np.random.default_rng(5)
    z = [rand_field(rng, P) for _ in range(layer.k_cur)]
    struct = mle_struct(w[2])
    args = (z, w[2], layer.add_gates, layer.mult_gates, layer.k_cur,
            layer.k_next, struct)
    arrays, finish = F.prove_layer_sumcheck_fused(*args, Mimc7(), defer=True,
                                                  device=DEVICE)
    if finish(F.download(arrays)) != prove_layer_sumcheck(*args, Mimc7()):
        raise AssertionError("fused layer transcript differs from the host engine's")
    arrays[2][0, 0] ^= 1
    try:
        finish(F.download(arrays))
    except RuntimeError as e:
        print(f"  corrupted device challenge: RuntimeError raised ({e})", flush=True)
    else:
        raise AssertionError("a corrupted device challenge passed the host check")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from gkr_tpu_torch import TorchBackend, prove, verify
    from gkr_tpu_torch.circuit import synth_circuit
    from gkr_tpu_torch.field import P, R
    from gkr_tpu_torch.mimc import Mimc7
    from gkr_tpu_torch.mle import mle_struct
    from gkr_tpu_torch.sumcheck import prove_layer_sumcheck
    from gkr_tpu_torch.torcheng import fused as F
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
        if "registers" in line or "spill" in line or "Function properties" in line:
            print("  ptxas: " + line.strip(), flush=True)

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

    print("[3] kernels against their plain versions (tolerance: bit-exact, "
          "max abs limb error 0)", flush=True)
    rows, record, bound = phase_kernels(K, L, P, R, sm_clock_hz)
    phase_fused_kernels(K, L, F, P, R, Mimc7, record, bound, circuit)

    Timed = timed_backend(TorchBackend)
    print("[4] per-round slice: prove(synth_circuit(20, 16), "
          "TorchBackend(fused=False))", flush=True)
    per_round, _, wall_pr = phase_slice(K, prove, verify, Timed(fused=False),
                                        circuit, w, EXPECTED_PER_ROUND)
    print("[4b] where the per-round prove's device time goes (torch.profiler)",
          flush=True)
    phase_profile(prove, lambda: TorchBackend(fused=False), circuit, w, wall_pr)

    print("[5] fused slice: prove(synth_circuit(20, 16), TorchBackend())",
          flush=True)
    backend = Timed()
    fused, proof, wall_f = phase_slice(K, prove, verify, backend, circuit, w,
                                       EXPECTED_FUSED)
    backend.seconds = {}
    again, wall_warm = sync_time(lambda: prove(circuit, w, backend=backend))
    if again != proof:
        raise AssertionError("a second fused proof of the circuit differs")
    print(f"  second prove, same backend (wiring plans cached): {wall_warm:.3f} s",
          flush=True)
    for name, sec in backend.seconds.items():
        print(f"    {name}: {sec:.3f} s", flush=True)
    print("[5b] where the fused prove's device time goes, plans cached "
          "(torch.profiler)", flush=True)
    phase_profile(prove, lambda: backend, circuit, w, wall_warm)
    print(f"  fused prove {wall_f:.3f} s (plans built), {wall_warm:.3f} s "
          f"(cached), against per-round {wall_pr:.3f} s (host clock, this run)",
          flush=True)
    del circuit, w, proof

    print("[6] card against CPU", flush=True)
    phase_card_vs_cpu(F, prove, verify, TorchBackend, synth_circuit, mle_struct,
                      prove_layer_sumcheck, Mimc7, P)

    for row in rows:
        src = per_round if row["name"] in LAUNCHES_FROM_PER_ROUND else fused
        row["launches"] = src[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(name_power)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
