#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gkr_tpu_torch) on one NVIDIA card.

Run from the root of the repository:  python3 chip_smoke.py

Phases, each fatal on failure:
  1. card: name, power limit, SM clock (nvidia-smi's max and a spin's
     reading; the peaks take the larger), device count;
  2. build: the CUDA kernels from gkr_tpu_torch/csrc with one nvcc (sm_90a);
     ptxas's registers and spills of every kernel (fails on a spill of a
     kernel whose product is fr_mul -- mont_mul, fold, the round evals, the
     eq table, normalize, the round tail's sum -- or of any Montgomery
     chain instance); the round evals' tile and resident blocks an SM;
     the SASS counts of the probes (IMADs a repetition of the peak chain;
     a Montgomery product of each variant: IMADs without moves, IMAD.WIDE,
     IMAD.HI, DFMA, FP64-pipe instructions, all instructions, its floor);
  3. kernels: the card's IMAD rate as the peak probe reads it, beside the
     card's peak (SMs x 64 x the peak SM clock), which with the price of a
     Montgomery product (probes.sass_summary: the least IMAD count of the
     integer variants, lowered to the FP64 variant's floor where that is
     lower) sets every compute bound; a reading faster than CEILING x its
     bound's rate fails (the bound would be wrong); then each kernel against its
     plain PyTorch version on the card at the shapes of the path that runs
     it (n = 2^20; the wiring plans of synth_circuit(20, 16); a bucket of
     70,000 gates; G = 1 and 132 round partials, the eval grid of a 2^20
     table, both timed, and 1024, round_tail's limit; the probes'
     (16, 2^20) words and 2^20 elements), random and edge inputs, bit-equal (the f32
     probe ops within a stated relative tolerance); the round evals also at
     n = 2, a ragged 2 tiles + 3 a half and 2^16, phase 2 at wb = 0, 1,
     p - 1 and a random value, `phase*_eval` in one launch with no other
     kernel (torch.profiler); the eq table in one launch at k = 1 .. 12,
     15, 16, 20 and 24 (also against the host's eq on sampled entries at 20
     and 24); the round tail's and
     mimc_multi's challenges also against the host Mimc7 on 262 lists;
     kernel and plain version timed with CUDA events (the round evals also
     at 2^16, launches queued), `index_add_` beside
     the segment sum, `torch.stack` beside the stack;
  4. per-round slice: prove(synth_circuit(20, 16)) with
     TorchBackend(fused=False), per-stage times, the port's verify, and the
     kernel launch counts of that one prove; then device time by kernel
     over one more prove (torch.profiler);
  5. fused slice: the same with TorchBackend(), the fused engine (three
     launches a round: partials, round_tail, fold); [5b] lists the device
     time of every kernel of the warm prove, the round evals' and the eq
     table's beside their bounds summed over the prove;
  6. card against CPU: synth_circuit(12, 10) proved on both with each
     engine, identical; a corrupted device challenge must make the fused
     layer's host check raise;
  7. pipelined slice: prove_pipelined(synth_circuit(20, 16)): its proof
     equals [5]'s, the port's verify accepts it, its launch counts are
     [5]'s with one `mimc_multi` (r*) and two more `mont_mul` (z-chain,
     line points) a layer, and the walk makes exactly 2 host syncs
     (torch.cuda.set_sync_debug_mode);
  8. the port bench, gkr_tpu_torch.bench.main() at k = 20: its JSON line,
     value > 0 and 0 < sol_vs_chip <= 1.05;
  9. the probe commands `micro` and `tune` (gkr_tpu_torch.probes; tune
     times every variant at every block width);
 10. the CLI flow on the card, in process through gkr_tpu_torch.cli.main:
     prove-native --example square --weak-gadget over 3 inputs --backend
     torch --export, prove-r1cs --workers 1, verify (every subcircuit OK,
     exit 0), each command's launches (prove-native's include round_tail
     and mimc_multi, through prove_pipelined; prove-r1cs's subcircuits are
     all at or under the host threshold, so it launches none); one field
     element flipped makes verify print FAIL and exit 1; the weak native
     aggregation's proofs on the card byte-equal to the host engine's;
 11. the full-strength native aggregation (`prove-native --example mimc
     --backend torch --export agg` over examples/mimc/input1, input2):
     each round's stages (gadget build, compile, prove, self-verify, host
     clock with a synchronize) and launches; round 1 (140,891 constraints,
     one 17-layer circuit of 4,718,592 gates) proved through
     prove_pipelined with every kernel of the fused path launched, its
     proof byte-equal to the fused prove() of the circuit recompiled from
     the export, its device time by kernel (torch.profiler); then
     prove-r1cs of the export with 4 threads and with 1 on the card (equal
     bytes) and verify of every subcircuit;
 12. the multi-device engine (gkr_tpu_torch.parallel): synth_circuit(20, 16)
     proved on the CLI's path (`--backend sharded --devices D`'s backend,
     `aggregator.prove_subcircuits`), a ShardedBackend over D = 2 and 8
     shards of the one card, each proof byte-equal to [5]'s, the round chain's launch counts exact
     (`expected_sharded`: D evals, one round_tail at G = D and D folds a
     round, then log2 D rounds on the gathered stack) and every kernel of
     the path launched, the wall clock beside [5]'s (the shards share one
     card: no multi-card figure), the port's verify of the D = 8 proof; one
     layer with a 70,000-gate bucket in one shard, its transcript equal to
     the host engine's;
 13. the in-circuit verifier executors on card proofs: the circom fixture's
     subcircuit 0 and the toy circuit proved with every layer on the fused
     kernels, each equal to the port's prove_spec; the port's interpreter
     (templated VerifyGKR and VerifyGKRStrongFS, gkr_tpu_torch/circuits)
     and native.verify_gkr_gadget accept the honest proofs; one value of
     each proof field tampered: both strong executors reject, the weak
     ones agree;
 14. the multi-controller path (gkr_tpu_torch.parallel.multihost): 2 ranks
     of one torch.distributed group on cuda:0 over gloo (NCCL refuses two
     ranks on one card), each proving synth_circuit(20, 16) through
     ShardedBackend(make_mesh(hosts=2)) at 1 and 4 shards a rank (global
     D = 2 and 8): each rank's proof byte-equal to [5]'s, its launches
     exact (`expected_multihost`) with every kernel of the sharded path
     launched, its collectives and their bytes exact (`expected_gathers`),
     the warm wall clock beside [5]'s and [12]'s (the ranks share the
     card: no multi-card figure), the port's verify of rank 0's proof; a
     70,000-gate bucket in rank 1's shard, both ranks' transcripts equal to
     the host engine's; the scaling twin's rows at k = 20 with its
     collective audit (shared rows: no headline on one card) and the
     subcircuits twin at 1, 2 and 4 threads on the card;
 15. the native host engine (gkr_tpu_torch.native: csrc/gkrhost.cpp, C++
     and OpenMP, built by g++ in [2]): the compiler, flags, build seconds,
     OpenMP threads and host CPU; its batch product and sum, Montgomery
     conversions, eq table and Moebius transform against the port's Python
     field and mle on 4,096 values with 0, 1 and p - 1; NativeMimc7
     against Mimc7 on 1,000 random lists; the bench's 2^20 layer through
     CppBackend against TorchBackend on the card (proof and challenges
     equal), timed; prove(synth_circuit(20, 16), CppBackend()) byte-equal
     to [5]'s proof and accepted by verify (with the native transcript,
     timed against an explicit Mimc7()); prove-r1cs --backend cpp of
     [10]'s export equal to its --backend torch proofs, verify exit 0; the
     2^20 table's sparse form by TorchBackend and by the C++ Moebius
     (equal, both timed); [8]'s bench line: cpp_gates_per_sec at "2^20"
     and vs_baseline = value / cpp_gates_per_sec;
then one JSON line of every kernel with its launches, time and bound.
The last line is {"ok": true, "device": {...}}; any failure exits non-zero
before it.  Imports nothing of jax or gkr_tpu.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from gkr_tpu_torch import tracing
from gkr_tpu_torch.probes import (FP32_PER_SM_CLOCK, IMAD_PER_SM_CLOCK, check_bound,
                                  event_ms, max_sm_clock_hz, peak_clock_hz,
                                  peak_per_s, queued_ms, spin_clock_hz)

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
ELEM_BYTES = 64                  # one field element: 16 int32 limbs
HASH_PRODUCTS = 3 * 4 * 91       # dependent products of a 3-element MiMC7-91 hash
RANDOM_HASH_LISTS = 256          # seeded 3-element lists the device hashes are held on
N = 1 << 20                      # the main path's table size
DEVICE = "cuda"

FUSED_ONLY = ("phase1_partials", "phase2_partials", "round_tail",
              "mimc_multi", "seg_sum", "normalize", "normalize_mul", "stack")
# Launches of one prove of synth_circuit(20, 16): three layer sumchecks with
# k_next = 20, 20, 16 (40 + 40 + 32 rounds) on the card.  Both engines build
# eq(z) over k_cur = 4, 20, 20 points and eq(b*) over 20, 20, 16, one
# eq_table launch a table.
EXPECTED_PER_ROUND = {"phase1_eval": 20, "phase2_eval": 20, "fold": 40,
                      "eq_table": 6, **{name: 0 for name in FUSED_ONLY}}
EXPECTED_FUSED = {
    "round_tail": 112, "mimc_multi": 0, "fold": 112,
    "phase1_partials": 56, "phase2_partials": 56,
    # 2 plans (phase 1, phase 2) per gate kind: 2 + 2 for each wide layer,
    # 1 + 1 for the output layer (add gates only)
    "seg_sum": 10,
    # HA1, HA2, HM, FA per wide layer; HA1, HA2, FA for the output layer
    "normalize": 11,
    "normalize_mul": 2,                 # FM * W~(b*), wide layers only
    "stack": 6,                         # one a build, two builds a layer
    "eq_table": 6,
    "phase1_eval": 0, "phase2_eval": 0,
}
LAUNCHES_FROM_PER_ROUND = ("phase1_eval", "phase2_eval")
LAUNCHES_FROM_PIPELINED = ("mimc_multi",)         # r*, one a layer
# The kernels line takes the other probes' launches from the path that runs them.
LAUNCHES_FROM_PROBES = ("u32_mul_chain", "micro_op", "mont_chain_cios32",
                        "mont_chain_school", "mont_chain_lat", "mont_chain_f64",
                        "mont_chain_cc")


def smi(fields: str, fmt: str = "csv,noheader") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", f"--format={fmt}"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def sync_time(fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


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


def stack_with_edges(rng, n: int, T: int, edges: list[int], L) -> torch.Tensor:
    """A random (n, T, 16) stack on the card with the edge values in the
    first entries of its lo half and, reversed, of its hi half."""
    S = random_limbs(rng, (n, T), DEVICE)
    k = min(len(edges), n // 2 * T)
    with_edges(S[:n // 2], (edges * T)[:k], L)
    with_edges(S[n // 2:], (edges[::-1] * T)[:k], L)
    return S


def rand_field(rng, P: int) -> int:
    return int.from_bytes(rng.bytes(32), "little") % P


def max_abs_err(x: torch.Tensor, y: torch.Tensor) -> float:
    if x.is_floating_point():
        return float((x - y).abs().max().item())
    return float((x.to(torch.int64) - y.to(torch.int64)).abs().max().item())


# ------------------------------------------------------------ stage seconds

def stage_time(fn):
    """fn() under `tracing.enable()` -> (its result, its host-clock seconds
    ending in a synchronize, the seconds of each `backend.*` span: the
    prover's calls into its backend, each of which ends in a host read)."""
    tracing.reset()
    tracing.enable()
    try:
        out, dt = sync_time(fn)
    finally:
        tracing.disable()
    return out, dt, {name: t.seconds for name, t in tracing.totals().items()
                     if name.startswith("backend.")}


# ------------------------------------------------------------------ phases

def phase_kernels(K, L, P, R, sm_clock_hz, imad_rate, imad_per_product):
    """Each kernel against its plain version at the path's shapes.  Compute
    bounds take `imad_per_product` IMAD slots a Montgomery product (the
    price of probes.sass_summary) at `imad_rate` IMADs a second (the card's
    peak)."""
    rng = np.random.default_rng(2024)
    dev = DEVICE
    edges = edge_values(P, R)
    pairs = [(x, y) for x in edges for y in edges]
    rows = []

    def bound(nbytes, products, serial=False, ops_ms=None):
        """Bytes at the memory rate against products at the card's IMAD
        peak, or, for one dependent chain (serial), at one thread's issue
        rate of one IMAD a clock; `ops_ms` gives the operations' time
        directly."""
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        rate = sm_clock_hz if serial else imad_rate
        t_ops = products * imad_per_product / rate * 1e3 if ops_ms is None else ops_ms
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    def record(name, replaces, got, want, ms, plain_ms, nbytes, products,
               library_ms=None, serial=False, ops_ms=None,
               source="gkr_tpu_torch/csrc/kernels.cu", rtol=None):
        """Hold got to want (bit-equal, or within a relative `rtol` for
        floats), hold the reading to its bound (check_bound), and keep the
        kernel's row."""
        err = max_abs_err(got, want)
        same = (torch.equal(got, want) if rtol is None
                else torch.allclose(got, want, rtol=rtol, atol=0))
        if not same:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version (max abs error {err})")
        b_ms, b_by = bound(nbytes, products, serial, ops_ms)
        check_bound(name, ms, b_ms)
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": 0,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": library_ms})
        lib = "" if library_ms is None else f"  library {library_ms:.4f} ms"
        agree = "bit-equal" if rtol is None else f"within rtol {rtol:.1e}"
        print(f"  {name:17s} {agree}  kernel {ms:.4f} ms  plain {plain_ms:.2f} ms  "
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

    # the per-round engine's evals at n = 2^20: one launch each, bit-equal,
    # no plain-torch kernel (torch.profiler)
    S1 = stack_with_edges(rng, N, 4, edges, L)
    got, want = one_launch(K, "phase1_eval", lambda: K.phase1_eval(S1)), K.phase1_eval_plain(S1)
    record("phase1_eval", "gkr_tpu/jaxeng/pallas_kernels.py:318", got, want,
           event_ms(lambda: K.phase1_eval(S1), 30),
           event_ms(lambda: K.phase1_eval_plain(S1), 2, 1),
           N * 4 * ELEM_BYTES, 3 * (N // 2))
    only_eval_kernels("phase1_eval", lambda: K.phase1_eval(S1))
    del S1
    S2 = stack_with_edges(rng, N, 3, edges, L)
    for wb_int in (rand_field(rng, P), P - 1, 0, 1):
        wb = L.pack_scalar(wb_int, dev)
        got = one_launch(K, "phase2_eval", lambda: K.phase2_eval(S2, wb))
        want = K.phase2_eval_plain(S2, wb)
        if not torch.equal(got, want):
            raise AssertionError(f"phase2_eval: disagrees at wb={wb_int}")
    record("phase2_eval", "gkr_tpu/jaxeng/pallas_kernels.py:368", got, want,
           event_ms(lambda: K.phase2_eval(S2, wb), 30),
           event_ms(lambda: K.phase2_eval_plain(S2, wb), 2, 1),
           N * 3 * ELEM_BYTES + ELEM_BYTES,
           3 * (N // 2) + 3 * K._eval_grid(N // 2))
    only_eval_kernels("phase2_eval", lambda: K.phase2_eval(S2, wb))
    del S2
    part = torch.zeros((K.TAIL_MAX_G, 3, 16), dtype=torch.int32, device=dev)
    print(f"  the plain second pass the evals ran before (limbs.sum_mod of "
          f"{K.TAIL_MAX_G} partials): {event_ms(lambda: L.sum_mod(part), 10):.4f} ms",
          flush=True)
    torch.cuda.synchronize()
    return rows, record, bound


def one_launch(K, name, fn):
    """fn(), which must launch the kernel counted under `name` once and
    nothing else of the port."""
    before = dict(K.LAUNCHES)
    out = fn()
    launched = {k: v - before[k] for k, v in K.LAUNCHES.items() if v != before[k]}
    if launched != {name: 1}:
        raise AssertionError(f"{name}: launched {launched}, not one {name}")
    return out


def only_eval_kernels(name, fn, calls=5, tries=3):
    """torch.profiler over warm calls of fn: their device kernels must be the
    eval kernel alone, once a call (no plain-torch pass after it).  A
    profile that dropped records -- no device activity at all, or one
    kernel seen fewer times than the calls (one H100 run recorded 4 of 5)
    -- is taken again; any other kernel fails at once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = {e.key: e.count for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA}
        if (len(kernels) > 1 or (kernels and "k_eval" not in next(iter(kernels)))
                or (kernels and next(iter(kernels.values())) >= calls)):
            break
    print(f"    {name}: device kernels of {calls} calls (torch.profiler): {kernels}",
          flush=True)
    if (len(kernels) != 1 or "k_eval" not in next(iter(kernels))
            or next(iter(kernels.values())) != calls):
        raise AssertionError(f"{name}: {calls} calls ran {kernels}, not the eval "
                             f"kernel alone once a call")


# Kernels whose ptxas report must show no spill, by a piece of the mangled
# name: every kernel whose product is fr_mul, and every Montgomery chain
# instance (the variants x 2 depths x 4 block widths)
NO_SPILL = {"k_mont_mul": "mont_mul, k_mont_mul", "k_fold": "fold, k_fold",
            "k_evalILi4E": "phase 1, k_eval<4>", "k_evalILi3E": "phase 2, k_eval<3>",
            "k_eq_table": "eq table, k_eq_table",
            "k_normalizeILb0E": "normalize, k_normalize<false>",
            "k_normalizeILb1E": "normalize with its scalar, k_normalize<true>",
            "k_round_tail": "round tail (its sum's products), k_round_tail",
            "k_mont_chain": "Montgomery chain, k_mont_chain"}


def kernel_report(K, ptxas: dict[str, str]):
    """The registers and spills ptxas reports for the kernels of NO_SPILL
    (fails on a spill or a missing report: one for each kernel, one for
    each Montgomery chain instance), and the eval kernels' residency on
    this card."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chains = len(K.MONT_VARIANTS) * len(K.MONT_DEPTHS) * len(K.MONT_BLOCKS)
    for key, label in NO_SPILL.items():
        reports = {name: p for name, p in ptxas.items() if key in name}
        if len(reports) != (chains if key == "k_mont_chain" else 1):
            raise AssertionError(f"{label}: {len(reports)} ptxas reports: {reports}")
        for name, props in reports.items():
            if " 0 bytes spill stores, 0 bytes spill loads" not in props:
                raise AssertionError(f"{label} {name}: spills:{props}")
        if len(reports) == 1:
            print(f"  {label}:{next(iter(reports.values()))}", flush=True)
        else:
            print(f"  {label}: {len(reports)} instances, no spill (their ptxas "
                  f"lines above)", flush=True)
    for tables, label in ((4, "phase 1, k_eval<4>"), (3, "phase 2, k_eval<3>")):
        a = K.eval_attrs(tables)
        warps = a["blocks_per_sm"] * a["threads"] // 32
        print(f"  {label}: {a['smem_bytes']} bytes of shared memory "
              f"a block ({a['tile']}-entry tiles); {a['blocks_per_sm']} "
              f"block(s) of {a['threads']} threads an SM = {warps} resident warps; "
              f"grid at most {K.EVAL_MAX_BLOCKS} on {sms} SMs", flush=True)
        if a["blocks_per_sm"] < 1:
            raise AssertionError(f"{label}: does not fit an SM: {a}")


def ptxas_report(log: str) -> dict[str, str]:
    """ptxas -v's lines, one per kernel: {mangled name: its properties}."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            out[name] = ""
        elif name and ("registers" in line or "spill" in line):
            out[name] += " " + line.split("info    :")[-1].strip()
    return out


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
    from gkr_tpu_torch.mle import eq_bits

    rng = np.random.default_rng(2025)
    dev = DEVICE
    edges = edge_values(P, R)

    # eq_table: one launch a table, bit-equal to the doubling at every
    # split into factor tables of EQ_BITS variables (k = 1 .. 12: one to
    # three tables, T_0 of every width), at 15, 16, 20 (the path's) and 24,
    # at random points and at points of edge values; at 20 and 24 also
    # against the host's eq(z, b) on sampled entries; k = 0 launches nothing
    # and a k beyond EQ_MAX_K is refused
    for k in (*range(1, 3 * K.EQ_BITS - 2), 15, 16, 20, 24):
        z = random_limbs(rng, (k,), dev)
        zedge = with_edges(random_limbs(rng, (k,), dev),
                           [edges[(i + k) % len(edges)] for i in range(k)], L)
        for pt in (zedge, z):
            got = one_launch(K, "eq_table", lambda: K.eq_table(pt))
            want = K.eq_table_plain(pt)
            if not torch.equal(got, want):
                raise AssertionError(f"eq_table k={k}: disagrees with its plain "
                                     f"version (max abs limb error "
                                     f"{max_abs_err(got, want)})")
        if k >= 20:
            point = L.unpack(z)
            idx = [0, (1 << k) - 1, *rng.integers(0, 1 << k, size=30).tolist()]
            if L.unpack(got[idx]) != [eq_bits(point, i) for i in idx]:
                raise AssertionError(f"eq_table k={k}: differs from the host's "
                                     f"eq(z, b)")
        if k in (4, 16, 24):
            b_ms, b_by = bound((k + (1 << k)) * ELEM_BYTES, 1 << k)
            print(f"  eq_table k={k}: kernel {event_ms(lambda: K.eq_table(z), 20):.4f} ms  "
                  f"bound {b_ms:.4f} ms ({b_by})", flush=True)
        if k == 20:
            z20, got20, want20 = z, got, want
        del got, want
    print(f"  eq_table: bit-equal at k = 1 .. {3 * K.EQ_BITS - 3}, 15, 16, 20, 24, "
          f"random and edge points, one launch a table", flush=True)
    before = dict(K.LAUNCHES)
    if not torch.equal(K.eq_table(z[:0]), K.eq_table_plain(z[:0])) or K.LAUNCHES != before:
        raise AssertionError("eq_table k=0: not [1] without a launch")
    try:
        K.eq_table(random_limbs(rng, (K.EQ_MAX_K + 1,), dev))
    except ValueError:
        pass
    else:
        raise AssertionError(f"eq_table took k = {K.EQ_MAX_K + 1}")
    record("eq_table", "gkr_tpu/jaxeng/pallas_kernels.py:214", got20, want20,
           event_ms(lambda: K.eq_table(z20), 20),
           event_ms(lambda: K.eq_table_plain(z20), 2, 1),
           (20 + N) * ELEM_BYTES, N)
    del got20, want20

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
           18 * N * 4 + N * ELEM_BYTES + ELEM_BYTES, 1.5 * N)
    del t, got, want

    # round_tail at the G the fused path gives it: 1 (the last rounds) and
    # the eval grid of a 2^20 table (every table of 2^15 entries or more),
    # and at its limit TAIL_MAX_G, lengths 2 and 3: edge partials, and
    # partials of p - 1 (the largest lazy sums); its challenge against the
    # host Mimc7
    host = Mimc7()
    tiny = torch.zeros(16, dtype=torch.int32, device=dev)
    launch_ms = event_ms(lambda: tiny.add_(0), 200)
    G_path = K._eval_grid(N // 2)
    tails = {}
    for G in (1, G_path, K.TAIL_MAX_G):
        for label, part in (("edges", with_edges(random_limbs(rng, (G, 3), dev),
                                                 edges[:3 * G], L)),
                            ("p - 1", L.pack([P - 1] * (3 * G), dev).reshape(G, 3, 16))):
            for length in (2, 3):
                got, want = K.round_tail(part, length), K.round_tail_plain(part, length)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"round_tail G={G} ({label}) length {length}: "
                                         f"disagrees with its plain version")
                coeffs = L.unpack(got[0])[3 - length:]
                if L.unpack_scalar(got[1]) != host.multi_hash(coeffs, 0):
                    raise AssertionError(f"round_tail G={G} length {length}: the "
                                         f"challenge differs from the host Mimc7")
            if label == "edges":
                tails[G] = (part, torch.cat([got[0], got[1][None]]),
                            torch.cat([want[0], want[1][None]]))

    # both device hashes on the lists the rounds hash: mimc_multi directly,
    # round_tail through one partial (y0, y1, y2) that interpolates to the
    # list (c2 random for a 2-element list)
    lists = [[0, 1], [P - 1, P - 1], [0, 1, P - 1], [P - 1, 0, 1],
             [rand_field(rng, P) for _ in range(2)],
             [rand_field(rng, P) for _ in range(3)]]
    lists += [[rand_field(rng, P) for _ in range(3)] for _ in range(RANDOM_HASH_LISTS)]
    outs = []
    for vals in lists:
        c2, c1, c0 = vals if len(vals) == 3 else [rand_field(rng, P)] + vals
        ys = [(c0 + c1 * t + c2 * t * t) % P for t in range(3)]
        co, r = K.round_tail(L.pack(ys, dev).reshape(1, 3, 16), len(vals))
        outs.append((co, r, K.mimc_multi(L.pack(vals, dev))))
    t0 = time.perf_counter()
    want = [host.multi_hash(vals, 0) for vals in lists]
    host_s = time.perf_counter() - t0
    for vals, w, (co, r, m) in zip(lists, want, outs):
        if L.unpack(co)[3 - len(vals):] != vals or L.unpack_scalar(r) != w:
            raise AssertionError(f"round_tail: differs from the host Mimc7 on {vals}")
        if L.unpack_scalar(m) != w:
            raise AssertionError(f"mimc_multi: differs from the host Mimc7 on {vals}")
    print(f"  round_tail and mimc_multi: the host Mimc7's challenge on {len(lists)} "
          f"lists ({RANDOM_HASH_LISTS} random; host hashing {host_s:.2f} s)", flush=True)

    consts = (K.MIMC_ROUNDS + 1) * ELEM_BYTES        # the constants and the challenge
    for G, replaces in ((G_path, "gkr_tpu/jaxeng/pallas_kernels.py:479"),
                        (1, "gkr_tpu/jaxeng/pallas_kernels.py:813")):
        part, got, want = tails[G]
        record("round_tail", replaces, got, want,
               event_ms(lambda: K.round_tail(part, 3), 50),
               event_ms(lambda: K.round_tail_plain(part, 3), 3, 1),
               (G * 3 + 3) * ELEM_BYTES + consts, HASH_PRODUCTS, serial=True)
        print(f"    (G = {G}, length 3; pl_round_coeffs and pl_mimc_multi in one "
              f"launch)", flush=True)
    print(f"    round_tail beside one tiny plain-torch launch back to back: "
          f"{launch_ms:.4f} ms", flush=True)

    x = L.pack(lists[-1], dev)
    ms = event_ms(lambda: K.mimc_multi(x), 50)
    record("mimc_multi", "gkr_tpu/jaxeng/pallas_kernels.py:813", K.mimc_multi(x),
           K.mimc_multi_plain(x), ms, event_ms(lambda: K.mimc_multi_plain(x), 5, 1),
           3 * ELEM_BYTES + consts, HASH_PRODUCTS, serial=True)
    print(f"    mimc_multi, 3 elements: {HASH_PRODUCTS} dependent products, "
          f"{ms / HASH_PRODUCTS * 1e6:.1f} ns each; bound: one thread issuing one "
          f"IMAD a clock", flush=True)

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

    # the partials entry points: n = 2 (the last fused round), a ragged
    # 2 tiles + 3 a half, 2^16 and 2^20 (more tiles than blocks), edge values,
    # phase 2 at wb = 0, 1, p - 1 and a random value; timed at 2^20 (the
    # kernels line) and at 2^16, launches queued behind a spin
    wbs = [L.pack_scalar(v, dev) for v in (0, 1, P - 1, s_int)]
    for n in (2, 2 * K.EVAL_TILE + 6, 1 << 16, N):
        S1 = stack_with_edges(rng, n, 4, edges, L)
        got, want = K.phase1_partials(S1), K.phase1_partials_plain(S1)
        if not torch.equal(got, want):
            raise AssertionError(f"phase1_partials n={n}: disagrees")
        S2 = stack_with_edges(rng, n, 3, edges, L)
        for wb in wbs:
            got2, want2 = K.phase2_partials(S2, wb), K.phase2_partials_plain(S2, wb)
            if not torch.equal(got2, want2):
                raise AssertionError(f"phase2_partials n={n}: disagrees at wb "
                                     f"{L.unpack_scalar(wb)}")
        G = K._eval_grid(n // 2)
        print(f"  phase1_partials, phase2_partials n={n} (G = {G}): bit-equal "
              f"(phase 2 at wb = 0, 1, p - 1, random)", flush=True)
        if n == 1 << 16:
            for name, fn, nbytes, products in (
                    ("phase1_partials", lambda: K.phase1_partials(S1), n * 4 * ELEM_BYTES,
                     3 * (n // 2)),
                    ("phase2_partials", lambda: K.phase2_partials(S2, s), n * 3 * ELEM_BYTES
                     + ELEM_BYTES, 3 * (n // 2) + 3 * G),
                    ("phase1_eval", lambda: K.phase1_eval(S1), n * 4 * ELEM_BYTES,
                     3 * (n // 2)),
                    ("phase2_eval", lambda: K.phase2_eval(S2, s), n * 3 * ELEM_BYTES
                     + ELEM_BYTES, 3 * (n // 2) + 3 * G)):
                b_ms, b_by = bound(nbytes, products)
                print(f"    {name} at 2^16: {queued_ms(fn, 200):.4f} ms queued "
                      f"(table in L2), bound {b_ms:.4f} ms ({b_by})", flush=True)
    record("phase1_partials", "gkr_tpu/jaxeng/pallas_kernels.py:406", got, want,
           event_ms(lambda: K.phase1_partials(S1), 30),
           event_ms(lambda: K.phase1_partials_plain(S1), 2, 1),
           N * 4 * ELEM_BYTES, 3 * (N // 2))
    record("phase2_partials", "gkr_tpu/jaxeng/pallas_kernels.py:428", got2, want2,
           event_ms(lambda: K.phase2_partials(S2, s), 30),
           event_ms(lambda: K.phase2_partials_plain(S2, s), 2, 1),
           N * 3 * ELEM_BYTES + ELEM_BYTES, 3 * (N // 2) + 3 * K._eval_grid(N // 2))
    del S1, S2
    torch.cuda.synchronize()


def phase_slice(K, prove, verify, backend, circuit, w, expected):
    """One prove with the launch counters reset just before and read just
    after; the port's verify; the counts against `expected`."""
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    proof, dt, stages = stage_time(lambda: prove(circuit, w, backend=backend))
    launches = dict(K.LAUNCHES)
    print(f"  prove (device stages, host clock with sync): {dt:.3f} s", flush=True)
    for name, sec in stages.items():
        print(f"    {name}: {sec:.3f} s", flush=True)
    print(f"  launches in this prove: {launches}", flush=True)
    print(f"  torch.cuda.max_memory_allocated: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    t0 = time.perf_counter()
    ok = verify(proof, circuit)
    print(f"  host: verify (port verifier): "
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

    torch.cuda.synchronize()
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, prof_wall = sync_time(lambda: prove(circuit, w, backend=make_backend()))
    spans = tracing.totals()          # the program's spans, recorded with it

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    from torch.autograd import DeviceType

    # device-side events only: kernels and copies, not the CPU ops that
    # launched them nor the GPU ranges of the program's spans
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == DeviceType.CUDA
              and dev_us(e) > 0 and e.key not in spans]
    total_s = sum(dev_us(e) for e in events) / 1e6
    if total_s == 0:
        print("  profiler: no device time recorded (busy share not measured)",
              flush=True)
        return {}
    print(f"  device busy {total_s:.3f} s: {100 * total_s / wall_s:.1f}% of the "
          f"unprofiled prove's {wall_s:.3f} s ({prof_wall:.3f} s with the "
          f"profiler on)", flush=True)
    for e in sorted(events, key=dev_us, reverse=True):
        print(f"    {dev_us(e) / 1e3:9.3f} ms  {e.count:6d} x  {e.key[:70]}",
              flush=True)
    print("  the program's spans (host clock, inclusive, profiler on):",
          flush=True)
    for name, t in spans.items():
        print(f"    {t.seconds * 1e3:9.3f} ms  {t.calls:3d} x  {name}", flush=True)
    return {e.key: (dev_us(e) / 1e3, e.count) for e in events}


def eval_totals_vs_bounds(K, circuit, bound, device_ms):
    """Each round eval kernel's [5b] total beside its bound summed over the
    prove's rounds (the tables halve every round: n = 2^k_next down to 2)."""
    for tables, name in ((4, "k_eval<4>"), (3, "k_eval<3>")):
        total = 0.0
        for layer in circuit.layers:
            for j in range(layer.k_next):
                n = 1 << (layer.k_next - j)
                extra = 3 * K._eval_grid(n // 2) if tables == 3 else 0
                total += bound(n * tables * ELEM_BYTES + (tables == 3) * ELEM_BYTES,
                               3 * (n // 2) + extra)[0]
        ms, count = next((v for k, v in device_ms.items() if name in k), (0.0, 0))
        print(f"  {name}: {ms:.3f} ms over {count} launches in [5b], against its "
              f"bound summed over those rounds {total:.4f} ms", flush=True)


def eq_total_vs_bound(circuit, bound, device_ms):
    """The eq kernel's [5b] total beside its bound summed over the prove's
    tables: eq(z) over k_cur and eq(b*) over k_next points a layer."""
    ks = [k for layer in circuit.layers for k in (layer.k_cur, layer.k_next)]
    total = sum(bound((k + (1 << k)) * ELEM_BYTES, 1 << k)[0] for k in ks)
    ms, count = next((v for key, v in device_ms.items() if "k_eq_table" in key),
                     (0.0, 0))
    print(f"  k_eq_table: {ms:.3f} ms over {count} launches in [5b] (tables at "
          f"k = {ks}), against its bound summed over them {total:.4f} ms",
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


def phase_probe_kernels(K, L, probes, P, R, record, imad_rate, fp32_rate, sass):
    """The bench's three probe kernels against their plain versions at the
    probes' shapes: (16, 2^20) u32 words, the same as i32/f32 words, 2^20
    Montgomery elements with edge values in the first rows.  Every integer
    Montgomery variant is bound by the shared price a product; a variant on
    the FP64 pipe by its own floor (probes.product_floor)."""
    dev = DEVICE
    words = probes.ROWS * probes.COLS

    # u32_mul_chain at both depths: bit-exact
    a, b = probes.peak_inputs(dev)
    for reps in K.CHAIN_REPS:
        got, want = K.u32_mul_chain(a, b, reps), K.u32_mul_chain_plain(a, b, reps)
        if not torch.equal(got, want):
            raise AssertionError(f"u32_mul_chain reps={reps}: disagrees with its plain version")
    reps = K.CHAIN_REPS[1]
    record("u32_mul_chain", "bench.py:133", got, want,
           event_ms(lambda: K.u32_mul_chain(a, b, reps), 10),
           event_ms(lambda: K.u32_mul_chain_plain(a, b, reps), 1, 1),
           3 * 4 * words, 0,
           ops_ms=words * K.CHAINS * reps / imad_rate * 1e3,
           source="gkr_tpu_torch/csrc/probes.cu")
    print(f"    (reps {reps}; SASS: {sass['peak_imad_per_rep']:g} IMADs a repetition "
          f"of the 8 chains)", flush=True)
    del a, b, got, want

    # micro_op: integer ops bit-exact at both depths; f32 within a relative
    # reps * 2^-22 (the plain f32_fma rounds twice a step, the kernel once:
    # at most 2^-23 relative a step, and earlier errors do not grow, since
    # every term is positive)
    row = None
    for op in K.MICRO_OPS:
        a, b = probes.micro_inputs(op, dev)
        for reps in K.MICRO_REPS:
            got, want = K.micro_op(op, a, b, reps), K.micro_op_plain(op, a, b, reps)
            ok = (torch.allclose(got, want, rtol=reps * 2.0 ** -22, atol=0)
                  if op.startswith("f32") else torch.equal(got, want))
            if not ok:
                raise AssertionError(f"micro_op {op} x {reps}: disagrees with its "
                                     f"plain version (max abs error {max_abs_err(got, want)})")
        reps = K.MICRO_REPS[0]
        ms = event_ms(lambda: K.micro_op(op, a, b, reps), 20)
        instr = sass[f"instr_per_rep_{op}"]
        rate = fp32_rate if op.startswith("f32") else imad_rate
        print(f"    micro_op {op:10s} x {reps}: {ms:.4f} ms, {instr:g} SASS "
              f"instructions a repetition", flush=True)
        if op == "u32_mul":
            row = (K.micro_op(op, a, b, reps), K.micro_op_plain(op, a, b, reps), ms,
                   event_ms(lambda: K.micro_op_plain(op, a, b, reps), 2, 1),
                   words * reps * instr / rate * 1e3)
    got, want, ms, plain_ms, ops_ms = row
    record("micro_op", "scripts/micro_vpu.py:38", got, want, ms, plain_ms,
           3 * 4 * words, 0, ops_ms=ops_ms, source="gkr_tpu_torch/csrc/probes.cu")
    print("    (the row: u32_mul at 16 repetitions, scripts/micro_vpu.py's measurement)",
          flush=True)
    del a, b, got, want

    # mont_chain, every variant, depths 1 and 9, every block width: bit-exact
    a, b = probes.mont_inputs(dev)
    edges = edge_values(P, R)
    with_edges(a, [x for x in edges for _ in edges], L)
    with_edges(b, [y for _ in edges for y in edges], L)
    n = a.shape[0]
    for variant in K.MONT_VARIANTS:
        for depth in K.MONT_DEPTHS:
            want = K.mont_chain_plain(a, b, depth)
            for block in K.MONT_BLOCKS:
                got = K.mont_chain(a, b, depth, variant, block)
                if not torch.equal(got, want):
                    raise AssertionError(f"mont_chain {variant} depth {depth} block "
                                         f"{block}: disagrees with its plain version")
        host = L.unpack(got[:len(edges) ** 2], montgomery=False)
        r_inv = pow(R, P - 2, P)
        pairs = [(x, y) for x in edges for y in edges]
        if host != [x * pow(y * r_inv, depth, P) % P for x, y in pairs]:
            raise AssertionError(f"mont_chain {variant}: edge values differ from host ints")
        floor = sass[f"floor_per_mont_mul_{variant}"]
        record(f"mont_chain_{variant}", "scripts/tune_pallas_mul.py:92", got, want,
               event_ms(lambda: K.mont_chain(a, b, depth, variant), 20),
               event_ms(lambda: K.mont_chain_plain(a, b, depth), 1, 1),
               3 * n * ELEM_BYTES, depth * n, source="gkr_tpu_torch/csrc/probes.cu",
               ops_ms=(depth * n * floor / imad_rate * 1e3
                       if variant in K.MONT_FP64 else None))
        print(f"    (depth {depth}, block 256; SASS a product: "
              f"{sass[f'imad_per_mont_mul_{variant}']:g} IMADs without moves, of "
              f"them {sass[f'wide_per_mont_mul_{variant}']:g} IMAD.WIDE and "
              f"{sass[f'hi_per_mont_mul_{variant}']:g} IMAD.HI; "
              f"{sass[f'dfma_per_mont_mul_{variant}']:g} DFMA of "
              f"{sass[f'fp64_per_mont_mul_{variant}']:g} FP64-pipe; "
              f"{sass[f'instr_per_mont_mul_{variant}']:g} instructions; floor "
              f"{floor:g} IMAD slots)", flush=True)
    del a, b, got, want
    torch.cuda.synchronize()


def phase_pipelined(K, F, prove_pipelined, verify, backend, circuit, w, proof,
                    fused_launches):
    """prove_pipelined on the [5] backend: the proof against [5]'s, the
    port's verify, its launch counts, and the host syncs of its walk."""
    depth = circuit.depth()
    expected = {**EXPECTED_FUSED, "mimc_multi": EXPECTED_FUSED["mimc_multi"] + depth,
                "mont_mul": fused_launches["mont_mul"] + 2 * depth}
    K.reset_launches()
    pipe, dt = sync_time(lambda: prove_pipelined(circuit, w, backend=backend))
    launches = dict(K.LAUNCHES)
    print(f"  prove_pipelined (host clock with sync, plans cached): {dt:.3f} s",
          flush=True)
    print(f"  launches in this prove: {launches}", flush=True)
    for name, want in expected.items():
        if launches[name] != want:
            raise AssertionError(f"{name}: {launches[name]} launches, expected {want}")
    if pipe != proof:
        raise AssertionError("the pipelined proof differs from prove()'s")
    t0 = time.perf_counter()
    if not verify(pipe, circuit):
        raise AssertionError("the port's verifier rejected the pipelined proof")
    print(f"  equal to [5]'s proof; host verify {time.perf_counter() - t0:.3f} s -> True",
          flush=True)

    # the walk alone (no sparse forms), every synchronizing call recorded
    downloads = F.DOWNLOADS
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            walk, dt_walk = sync_time(lambda: prove_pipelined(
                circuit, w, backend=backend, materialize_sparse=False))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(c.message) for c in caught
             if "called a synchronizing CUDA operation" in str(c.message)]
    print(f"  the walk without the sparse forms: {dt_walk:.3f} s, "
          f"{len(syncs)} synchronizing calls, {F.DOWNLOADS - downloads} downloads",
          flush=True)
    if len(syncs) != 2 or F.DOWNLOADS - downloads != 2:
        raise AssertionError(f"the pipelined walk synchronized {len(syncs)} times "
                             f"({F.DOWNLOADS - downloads} downloads), not 2: {syncs[:4]}")
    if walk.sumcheck_proofs != proof.sumcheck_proofs or walk.z != proof.z:
        raise AssertionError("the walk without the sparse forms proves otherwise")
    return launches, dt


def phase_bench(K, bench):
    """The port bench's main path at its default k = 20."""
    os.environ.pop("GKR_BENCH_EXTRA", None)
    K.reset_launches()
    out, dt = sync_time(bench.main)
    launches = dict(K.LAUNCHES)
    roof = out["roofline"]
    print(f"  bench.main: {dt:.1f} s; launches {launches}", flush=True)
    if not out["value"] > 0:
        raise AssertionError(f"bench value {out['value']}")
    if roof is None or not 0 < roof["sol_vs_chip"] <= 1.05:
        raise AssertionError(f"bench roofline {roof} ({out.get('roofline_reason')})")
    return launches, out


def phase_probe_paths(K, probes):
    """The probe commands, each with the counters reset just before."""
    launches = {}
    for cmd in ("micro", "tune"):
        K.reset_launches()
        if probes.main([cmd]) != 0:
            raise AssertionError(f"probes {cmd} failed")
        launches.update({k: v for k, v in K.LAUNCHES.items() if v})
    return launches


def run_cli(cli, argv: list[str]) -> tuple[int, str]:
    """`python -m gkr_tpu_torch <argv>` in process: its exit code and what it
    printed (also printed here, indented)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    lines = out.splitlines()
    for line in lines[:4]:
        print(f"    | {line}", flush=True)
    if len(lines) > 4:
        print(f"    | ... ({len(lines) - 4} more lines)", flush=True)
    return rc, out


def check_verify_output(rc: int, out: str, n_proofs: int | None = None) -> int:
    """`verify` exited 0 and printed OK for every subcircuit."""
    lines = [ln for ln in out.splitlines() if ln.startswith("subcircuit ")]
    if rc != 0 or not lines or any(not ln.endswith(": OK") for ln in lines):
        raise AssertionError(f"verify: rc {rc}, {out[-400:]}")
    if n_proofs is not None and len(lines) != n_proofs:
        raise AssertionError(f"verify checked {len(lines)} of {n_proofs} proofs")
    return len(lines)


def flipped_verify(cli, P, proof_path: str, r1cs: str, wtns: str) -> None:
    """One field element of proofs.json flipped: `verify` prints FAIL and
    exits 1."""
    with open(proof_path) as f:
        data = json.load(f)
    rnd = data["proofs"][0]["sumcheckProof"][0][0]
    rnd[0] = str((int(rnd[0]) + 1) % P)
    bad = proof_path.replace(".json", "_flipped.json")
    with open(bad, "w") as f:
        json.dump(data, f)
    rc, out = run_cli(cli, ["verify", "--proof", bad, "--r1cs", r1cs, "--wtns", wtns])
    if rc != 1 or "subcircuit 0: FAIL" not in out:
        raise AssertionError(f"a flipped element: verify rc {rc}, {out[-400:]}")
    print("  one field element flipped in proofs.json: verify prints FAIL for "
          "subcircuit 0 and exits 1", flush=True)


def launched(K) -> dict[str, int]:
    return {k: v for k, v in K.LAUNCHES.items() if v}


def phase_cli_flow(K, P, tmp: str) -> None:
    """The verify skill's weak CLI flow with --backend torch, in process, the
    launch counters reset before each command and read after it; then the
    card's native aggregation against the host engine's."""
    from gkr_tpu_torch import HostBackend, TorchBackend, cli
    from gkr_tpu_torch.examples import square_chain_example
    from gkr_tpu_torch.frontend import R1csFile, WtnsFile, compile_r1cs_to_gkr
    from gkr_tpu_torch.recursion.native import prove_all_native

    values = [{"in1": v} for v in (3, 5, 7)]
    paths = []
    for i, v in enumerate(values, 1):
        paths.append(os.path.join(tmp, f"i{i}.json"))
        with open(paths[-1], "w") as f:
            json.dump(v, f)
    agg, proofs = os.path.join(tmp, "aggregated"), os.path.join(tmp, "proofs.json")
    r1cs, wtns = agg + ".r1cs", agg + ".wtns"
    steps = (("prove-native", ["prove-native", "--example", "square", "--weak-gadget",
                               "-i", *paths, "--backend", "torch", "--export", agg]),
             ("prove-r1cs", ["prove-r1cs", "--r1cs", r1cs, "--wtns", wtns,
                             "--backend", "torch", "--workers", "1", "-o", proofs]),
             ("verify", ["verify", "--proof", proofs, "--r1cs", r1cs, "--wtns", wtns]))
    counts = {}
    for label, argv in steps:
        print(f"  python -m gkr_tpu_torch {' '.join(argv)}", flush=True)
        K.reset_launches()
        (rc, out), dt = sync_time(lambda: run_cli(cli, argv))
        counts[label] = launched(K)
        print(f"  {label}: exit {rc}, {dt:.3f} s; launches {counts[label]}", flush=True)
        if rc != 0:
            raise AssertionError(f"{label} exited {rc}")
        if label == "verify":
            n = check_verify_output(rc, out)
            print(f"  verify: all {n} subcircuits OK", flush=True)
    missing = [k for k in ("round_tail", "mimc_multi") if not counts["prove-native"].get(k)]
    if missing:
        raise AssertionError(f"prove-native launched no {missing}: not through "
                             "prove_pipelined")
    circuits, _, _ = compile_r1cs_to_gkr(R1csFile.read(r1cs), WtnsFile.read(wtns))
    max_k = max(l.k_next for c in circuits for l in c.layers)
    if counts["prove-r1cs"] or max_k > TorchBackend().host_threshold:
        raise AssertionError(f"prove-r1cs: launches {counts['prove-r1cs']}, max k {max_k}")
    print(f"  prove-r1cs here reaches no kernel: its {len(circuits)} subcircuits "
          f"have k <= {max_k}, at or under host_threshold, so the host engine "
          f"proves every layer", flush=True)
    flipped_verify(cli, P, proofs, r1cs, wtns)

    def native(backend):
        return prove_all_native(square_chain_example, values, backend=backend,
                                full_fs=False, recombination=False)

    card, dt_card = sync_time(lambda: native(TorchBackend()))
    host, dt_host = sync_time(lambda: native(HostBackend()))
    if [json.dumps(p.to_dict()) for p in card] != [json.dumps(p.to_dict()) for p in host]:
        raise AssertionError("prove_all_native on the card differs from the host engine")
    print(f"  prove_all_native(square, 3 inputs, weak): the card's {len(card)} "
          f"proof(s) byte-equal to the host engine's ({dt_card:.3f} s against "
          f"{dt_host:.3f} s, host clock)", flush=True)


ON_AGGREGATION_PATH = ("mont_mul", "fold", "phase1_partials", "phase2_partials",
                       "round_tail", "normalize", "normalize_mul", "eq_table",
                       "seg_sum", "mimc_multi", "stack")
ROUND1 = {"constraints": 140891, "layers": 17, "gates": 4718592}   # gkr_tpu's round 1


def phase_aggregation(K, tmp: str):
    """Round 1 of the full-strength mimc aggregation, as `prove-native
    --example mimc --backend torch --export agg` drives it over
    examples/mimc/input1.json and input2.json (`prove_round_native`'s
    stages, each timed by `bench.aggregation_round`; the export as
    `prove_all_native` writes it); its proof against the fused prove() of
    the same circuit; then prove-r1cs of the export with 4 and 1 threads on
    the card, and verify."""
    from gkr_tpu_torch import TorchBackend, cli, prove, prove_pipelined
    from gkr_tpu_torch.bench import STAGES, aggregation_round
    from gkr_tpu_torch.examples import mimc_example
    from gkr_tpu_torch.frontend import R1csFile, WtnsFile, compile_r1cs_to_gkr
    from gkr_tpu_torch.recursion.native import export_native

    agg = os.path.join(tmp, "agg")
    backend, pairs, rounds = TorchBackend(), None, []
    t0 = time.perf_counter()
    for i in (1, 2):
        with open(os.path.join("examples", "mimc", f"input{i}.json")) as f:
            user_input = json.load(f)
        pairs, builder, st = aggregation_round(mimc_example, user_input, pairs, backend)
        rounds.append(st)
    export_native(agg, builder)
    torch.cuda.synchronize()
    proofs = [p for p, _ in pairs]
    print(f"  prove-native's rounds (mimc, input1, input2, TorchBackend(), full-strength "
          f"defaults) and the export: {time.perf_counter() - t0:.3f} s, "
          f"{len(proofs)} proof(s)", flush=True)
    for i, st in enumerate(rounds):
        print(f"    round {i}: {st['constraints']} constraints; "
              + ", ".join(f"{k} {st[k]:.3f} s" for k in (*STAGES, "total")),
              flush=True)
        print(f"      launches: {st['launches']}", flush=True)
    round1 = rounds[1]
    if round1["launches"].get("mimc_multi", 0) <= 0:     # r*: prove_pipelined only
        raise AssertionError(f"round 1 did not go through prove_pipelined: "
                             f"{round1['launches']}")
    missing = [k for k in ON_AGGREGATION_PATH if not round1["launches"].get(k)]
    if missing or any(round1["launches"].get(k) for k in ("phase1_eval", "phase2_eval")):
        raise AssertionError(f"round 1's launches: missing {missing}, "
                             f"{round1['launches']}")

    t0 = time.perf_counter()
    circuits, ws, _ = compile_r1cs_to_gkr(R1csFile.read(agg + ".r1cs"),
                                          WtnsFile.read(agg + ".wtns"), width_limit=1)
    t_compile = time.perf_counter() - t0
    circuit, w = circuits[0], ws[0]
    shape = {"constraints": round1["constraints"], "layers": circuit.depth(),
             "gates": sum(l.n_gates() for l in circuit.layers)}
    print(f"  round 1 recompiled from agg.r1cs / agg.wtns at width_limit 1 in "
          f"{t_compile:.3f} s: {shape}, k = {circuit.k_list()}", flush=True)
    if len(circuits) != 1 or shape != ROUND1:
        raise AssertionError(f"round 1 is {len(circuits)} circuit(s) of {shape}, "
                             f"gkr_tpu's is {ROUND1}")
    backend = TorchBackend()
    fused, dt_fused = sync_time(lambda: prove(circuit, w, backend=backend))
    if json.dumps(fused.to_dict()) != json.dumps(proofs[0].to_dict()):
        raise AssertionError("round 1: prove_pipelined's proof differs from prove()'s")
    print(f"  round 1's proof (prove_pipelined, self-verified by the port's "
          f"verifier) byte-equal to prove(circuit, w, TorchBackend()), the fused "
          f"engine without the pipelined walk ({dt_fused:.3f} s, plans built)",
          flush=True)
    _, dt_pipe = sync_time(lambda: prove_pipelined(circuit, w, backend=backend))
    print(f"  prove_pipelined again, plans cached: {dt_pipe:.3f} s", flush=True)
    print("  where round 1's pipelined prove's device time goes (torch.profiler):",
          flush=True)
    phase_profile(prove_pipelined, lambda: backend, circuit, w, dt_pipe)
    del circuits, ws, circuit, w, fused, backend

    out = {}
    for workers in (4, 1):
        path = os.path.join(tmp, f"proofs_w{workers}.json")
        argv = ["prove-r1cs", "--r1cs", agg + ".r1cs", "--wtns", agg + ".wtns",
                "--backend", "torch", "--workers", str(workers), "-o", path]
        K.reset_launches()
        (rc, _), dt = sync_time(lambda: run_cli(cli, argv))
        counts = launched(K)
        print(f"  prove-r1cs --workers {workers}: exit {rc}, {dt:.3f} s; launches "
              f"{counts}{' (threads share the counters)' if workers > 1 else ''}",
              flush=True)
        if rc != 0 or not counts.get("round_tail"):
            raise AssertionError(f"prove-r1cs --workers {workers}: rc {rc}, {counts}")
        with open(path, "rb") as f:
            out[workers] = f.read()
    if out[4] != out[1]:
        raise AssertionError("prove-r1cs: --workers 4 and --workers 1 differ")
    n = len(json.loads(out[1])["proofs"])
    print(f"  --workers 4 and --workers 1 wrote the same bytes ({n} subcircuit proofs)",
          flush=True)
    (rc, text), dt = sync_time(lambda: run_cli(cli, [
        "verify", "--proof", os.path.join(tmp, "proofs_w4.json"),
        "--r1cs", agg + ".r1cs", "--wtns", agg + ".wtns"]))
    check_verify_output(rc, text, n)
    print(f"  verify: all {n} subcircuits OK ({dt:.3f} s)", flush=True)
    return round1


# The kernels the sharded engine launches on every layer ([12]).
ON_SHARDED_PATH = ("phase1_eval", "phase2_eval", "phase1_partials", "phase2_partials",
                   "round_tail", "fold", "seg_sum", "eq_table", "mont_mul",
                   "normalize", "normalize_mul", "stack")


def expected_sharded(circuit, D: int) -> dict[str, int]:
    """The sharded engine's launches of the round chain for one prove over D
    shards on one device: while a shard holds 2 rows or more, D evals, one
    round_tail (G = D) and D folds a round; then log2 D rounds of the
    fused engine on the gathered (D, t, 16) stack; eq(z), eq_hi and eq_lo
    once a layer (one distinct device)."""
    ld = D.bit_length() - 1
    ks = [layer.k_next for layer in circuit.layers]
    local = sum(k - ld for k in ks)
    tail = ld * len(ks) if D > 1 else 0
    return {"phase1_eval": local * D, "phase2_eval": local * D,
            "phase1_partials": tail, "phase2_partials": tail,
            "round_tail": 2 * sum(ks), "fold": 2 * (local * D + tail),
            "eq_table": 3 * len(ks), "mimc_multi": 0}


def phase_sharded(K, P, verify, circuit, w, proof, wall_warm: float,
                  name_power: str) -> dict[int, float]:
    """synth_circuit(20, 16) proved over D = 2 and 8 shards of the one card
    on the CLI's path (`--backend sharded --devices D`: the backend of
    `cli._backend_args`, the subcircuit proved by
    `aggregator.prove_subcircuits`): the proof byte-equal to [5]'s
    single-device fused proof, its launch counts (the sharded engine's, not
    `prove_pipelined`'s), the wall clock beside [5]'s; the port's verify of
    the D = 8 proof; then one hot-bucket layer against the host engine.
    -> the warm prove's seconds by D."""
    import argparse

    from gkr_tpu_torch import cli
    from gkr_tpu_torch.mimc import Mimc7
    from gkr_tpu_torch.mle import mle_struct
    from gkr_tpu_torch.parallel import ShardedBackend, ShardedSumcheck, make_mesh
    from gkr_tpu_torch.recursion.aggregator import prove_subcircuits
    from gkr_tpu_torch.sumcheck import prove_layer_sumcheck

    want = json.dumps(proof.to_dict())
    card = torch.device(DEVICE)
    counts, warm = {}, {}
    for D in (2, 8):
        kw = cli._backend_args(argparse.Namespace(backend="sharded", device=None,
                                                  devices=D, workers=None))
        backend = kw["backend"]
        if not isinstance(backend, ShardedBackend) or \
                backend.mesh != make_mesh(devices=[card] * D):
            raise AssertionError(f"--backend sharded --devices {D}: {kw}")

        def run():
            return prove_subcircuits([circuit], [w], check_verify=False, **kw)[0]

        K.reset_launches()
        got, dt_cold = sync_time(run)
        counts[D] = launched(K)
        again, dt_warm = sync_time(run)
        warm[D] = dt_warm
        if json.dumps(got.to_dict()) != want or json.dumps(again.to_dict()) != want:
            raise AssertionError(f"D = {D}: the sharded proof differs from [5]'s")
        print(f"  D = {D}: launches {counts[D]}", flush=True)
        exp = expected_sharded(circuit, D)
        wrong = {k: (counts[D].get(k, 0), v) for k, v in exp.items()
                 if counts[D].get(k, 0) != v}
        missing = [k for k in ON_SHARDED_PATH if not counts[D].get(k)]
        if wrong or missing:
            raise AssertionError(f"D = {D}: launches (got, expected) {wrong}, "
                                 f"missing {missing}")
        print(f"  D = {D} shards of one card ({name_power}): prove {dt_warm:.3f} s "
              f"(plans cached), {dt_cold:.3f} s (plans built), against the "
              f"single-device fused prove's {wall_warm:.3f} s ([5], plans cached), "
              f"host clock; the {D} shards share one card, so this is no "
              f"multi-card figure; proof byte-equal to [5]'s", flush=True)
    t0 = time.perf_counter()
    if not verify(got, circuit):
        raise AssertionError("the port's verifier rejected the D = 8 proof")
    print(f"  host: verify of the D = 8 proof: {time.perf_counter() - t0:.3f} s -> "
          f"True (D = 2's is the same bytes)", flush=True)

    # A hot bucket: 70,000 add gates with left input 0, bucket 0 of shard 0
    # in phase 1, at a random point (full-size weights): the per-shard
    # segment sum must carry past 2^16 gates (the reference's fault,
    # fused.py:83-101); the other outputs are random mult gates
    rng = np.random.default_rng(12)
    k_cur, k_next, hot = 17, 10, 70_000
    lr = rng.integers(0, 1 << k_next, size=(1 << k_cur, 2)).tolist()
    add = [(o, 0, lr[o][1]) for o in range(hot)]
    mult = [(o, *lr[o]) for o in range(hot, 1 << k_cur)]
    w_next = [rand_field(rng, P) for _ in range(1 << k_next)]
    z = [rand_field(rng, P) for _ in range(k_cur)]
    struct = mle_struct(w_next)
    K.reset_launches()
    got, dt = sync_time(lambda: ShardedSumcheck(make_mesh(devices=[card] * 2))
                        .prove_layer_sumcheck(z, w_next, add, mult, k_cur, k_next,
                                              struct, Mimc7()))
    hot_counts = launched(K)
    if got != tuple(prove_layer_sumcheck(z, w_next, add, mult, k_cur, k_next, struct,
                                         Mimc7())):
        raise AssertionError("the hot-bucket layer's sharded transcript differs "
                             "from the host engine's")
    if not hot_counts.get("seg_sum"):
        raise AssertionError(f"the hot-bucket layer launched no seg_sum: {hot_counts}")
    print(f"  hot bucket: {hot:,} add gates on left input 0 (bucket 0 of shard 0 of 2), "
          f"2^{k_next} entries: transcript equal to the host engine's "
          f"({dt:.3f} s; launches {hot_counts})", flush=True)
    return warm


def expected_multihost(circuit, D: int, d_local: int) -> dict[str, int]:
    """One rank's launches of the round chain for one prove over D = H *
    d_local shards, d_local of them this rank's, on one device: d_local
    evals and folds a local round, every round's round_tail (G = D, then
    the gathered tail's, which every rank runs), log2 D tail rounds a phase,
    eq(z), eq_hi and eq_lo once a layer.  Summed over the H ranks, the evals
    are `expected_sharded`'s."""
    ld = D.bit_length() - 1
    ks = [layer.k_next for layer in circuit.layers]
    local = sum(k - ld for k in ks)
    tail = ld * len(ks)
    return {"phase1_eval": local * d_local, "phase2_eval": local * d_local,
            "phase1_partials": tail, "phase2_partials": tail,
            "round_tail": 2 * sum(ks), "fold": 2 * (local * d_local + tail),
            "eq_table": 3 * len(ks), "mimc_multi": 0}


def expected_gathers(circuit, D: int, hosts: int) -> tuple[dict, dict]:
    """One rank's collectives for one prove over D shards of `hosts` ranks,
    and the bytes each gathered: a layer's, as the single controller's
    (`scaling.expected_collectives`: k - log2 D round gathers of D (3, 16)
    sums and one tail gather of D one-row stacks a phase), and one
    exchange of 32-byte challenge digests."""
    from gkr_tpu_torch.parallel.scaling import expected_collectives

    counts, nbytes = {}, {}
    for layer in circuit.layers:
        c, b = expected_collectives(layer.k_next, D)
        c["digest"], b["digest"] = 1, hosts * 32
        for kind in c:
            counts[kind] = counts.get(kind, 0) + c[kind]
            nbytes[kind] = nbytes.get(kind, 0) + b[kind]
    return counts, nbytes


def phase_multihost(P, verify, circuit, proof, wall_warm: float,
                    sharded_warm: dict[int, float], name_power: str, tmp: str) -> None:
    """The multi-controller path: 2 ranks (python -m
    gkr_tpu_torch.parallel.multihost.spawn) on cuda:0 over gloo, each
    proving synth_circuit(20, 16) through
    ShardedBackend(make_mesh(hosts=2)) at 1 and 4 shards a rank (global D
    = 2 and 8): each rank's proof byte-equal to [5]'s, its launches
    (`expected_multihost`) and collectives (`expected_gathers`) exact,
    every kernel of the path launched on each rank, the port's verify of
    rank 0's D = 2 proof; a 70,000-gate bucket in rank 1's shard against
    the host engine; then the scaling twin's rows at k = 20 with its
    collective audit and the subcircuits twin at 1, 2 and 4 threads."""
    from gkr_tpu_torch.mimc import Mimc7
    from gkr_tpu_torch.mle import mle_struct
    from gkr_tpu_torch.parallel import multihost, scaling
    from gkr_tpu_torch.proof import Proof
    from gkr_tpu_torch.recursion import subcircuits
    from gkr_tpu_torch.sumcheck import prove_layer_sumcheck

    hosts = 2
    want = multihost.proof_digest(proof)
    proof_out = os.path.join(tmp, "rank0_proof.json")
    # synth_circuit(k, k_input): layers (4, k), (k, k), (k, k_input)
    synth = {"k": circuit.layers[0].k_next, "k_input": circuit.input_k}
    hot = {"k_cur": 17, "k_next": 10, "hot": 70_000, "seed": 12}
    jobs = [("prove", {**synth, "d_local": 1, "want": want, "proof_out": proof_out}),
            ("prove", {**synth, "d_local": 4, "want": want}),
            ("hot", {**hot, "d_local": 1})]
    t0 = time.perf_counter()
    ranks = multihost.spawn(jobs, hosts=hosts, d_local=1, device=DEVICE, timeout=600,
                            log=lambda s: print(f"  {s}", flush=True))
    print(f"  2 ranks, 3 jobs: {time.perf_counter() - t0:.3f} s with the ranks' "
          "start", flush=True)
    for j, d_local in ((0, 1), (1, 4)):
        D = hosts * d_local
        exp = expected_multihost(circuit, D, d_local)
        summed = expected_sharded(circuit, D)
        if hosts * exp["phase1_eval"] != summed["phase1_eval"]:
            raise AssertionError(f"D = {D}: the ranks' evals do not add up to "
                                 f"expected_sharded's {summed['phase1_eval']}")
        gathers = expected_gathers(circuit, D, hosts)
        for r, res in enumerate(ranks):
            job = res[j]
            if job["digest"] != want or job["foreign_modules"]:
                raise AssertionError(f"rank {r}, D = {D}: proof digest {job['digest']} "
                                     f"(want [5]'s {want}), imports {job['foreign_modules']}")
            got = job["launches"]
            wrong = {k: (got.get(k, 0), v) for k, v in exp.items() if got.get(k, 0) != v}
            missing = [k for k in ON_SHARDED_PATH if not got.get(k)]
            if wrong or missing:
                raise AssertionError(f"rank {r}, D = {D}: launches (got, expected) "
                                     f"{wrong}, missing {missing}")
            if (job["collectives"], job["collective_bytes"]) != gathers:
                raise AssertionError(f"rank {r}, D = {D}: collectives "
                                     f"{job['collectives']} {job['collective_bytes']}, "
                                     f"expected {gathers}")
            cold, warm = job["seconds"]
            print(f"  rank {r}, D = {D} ({d_local} a rank): launches {got}; "
                  f"collectives {job['collectives']}, bytes {job['collective_bytes']}",
                  flush=True)
            print(f"  rank {r}, D = {D} ({name_power}): prove {warm:.3f} s (plans "
                  f"cached), {cold:.3f} s (plans built), against [5]'s single-device "
                  f"{wall_warm:.3f} s and [12]'s {sharded_warm[D]:.3f} s at D = {D}, "
                  "host clock; 2 ranks on one card over gloo, so no multi-card "
                  "figure; proof byte-equal to [5]'s", flush=True)
    t0 = time.perf_counter()
    if not verify(Proof.from_json_file(proof_out), circuit):
        raise AssertionError("the port's verifier rejected rank 0's proof")
    print(f"  host: verify of rank 0's D = 2 proof: {time.perf_counter() - t0:.3f} s "
          "-> True", flush=True)

    left = hosts - 1                 # D = 2: rank 1's shard
    z, w_next, add, mult = multihost.hot_layer(left=left, **hot)
    want_hot = prove_layer_sumcheck(z, w_next, add, mult, hot["k_cur"], hot["k_next"],
                                    mle_struct(w_next), Mimc7())
    for r, res in enumerate(ranks):
        job = res[2]
        if job["left"] != left or (job["proof"], job["challenges"]) != \
                tuple(map(list, want_hot)):
            raise AssertionError(f"rank {r}: the hot-bucket layer's transcript "
                                 "differs from the host engine's")
    rows0 = [res[2]["row0_add_gates"] for res in ranks]
    if rows0 != [[0], [hot["hot"]]] or not ranks[1][2]["launches"].get("seg_sum"):
        raise AssertionError(f"the hot bucket is not rank 1's: row 0's add gates "
                             f"{rows0}, rank 1's launches {ranks[1][2]['launches']}")
    print(f"  hot bucket: {hot['hot']:,} add gates on left input {left} (rank 1's "
          f"shard of D = 2), 2^{hot['k_next']} entries: both ranks' transcripts "
          f"equal the host engine's; rank 1's launches {ranks[1][2]['launches']}",
          flush=True)

    res = scaling.run(20, reps=2, ds=(1, 2, 4, 8), device=DEVICE,
                      log=lambda s: print(f"  scaling: {s}", flush=True))
    print(f"  scaling ({name_power}): " + json.dumps(res), flush=True)
    if res["headline_efficiency"] is not None and torch.cuda.device_count() == 1:
        raise AssertionError("a scaling headline from one card")
    res = subcircuits.run(4, 12, workers=(1, 2, 4), pools=("torch",), device=DEVICE,
                          log=lambda s: print(f"  subcircuits: {s}", flush=True))
    print(f"  subcircuits ({name_power}): " + json.dumps(res), flush=True)


# Tampers of one value of each proof field, applied to the padded proof both
# executors consume; each targets a structural (non-padding) position.
TAMPERS = {
    "coeffs": lambda p, P: p.sumcheck_proofs[0][1].__setitem__(
        -1, (p.sumcheck_proofs[0][1][-1] + 1) % P),
    "q": lambda p, P: p.q[0].__setitem__(-1, (p.q[0][-1] + 1) % P),
    "z": lambda p, P: p.z[1].__setitem__(0, (p.z[1][0] + 1) % P),
    "r": lambda p, P: p.r.__setitem__(0, (p.r[0] + 1) % P),
    "sumcheckr": lambda p, P: p.sumcheck_r[0].__setitem__(
        1, (p.sumcheck_r[0][1] + 1) % P),
    "d": lambda p, P: p.d[0].__setitem__(0, (p.d[0][0] + 1) % P),
    "input_func": lambda p, P: p.input_func[0].__setitem__(
        0, (p.input_func[0][0] + 1) % P),
}


def phase_executors(K, P, tmp: str) -> None:
    """The fixture's subcircuit 0 (tests/fixtures/circom_mimc) and the toy
    circuit proved on the card with every layer through the fused kernels;
    each proof equal to the port's spec prover's; then the tamper matrix
    over the port's two in-circuit verifier executors: the circom
    interpreter on the templated VerifyGKR / VerifyGKRStrongFS circuits
    (gkr_tpu_torch/circuits) and native.verify_gkr_gadget."""
    from gkr_tpu_torch import TorchBackend, prove
    from gkr_tpu_torch.circuit import GateLayer, GKRCircuit
    from gkr_tpu_torch.frontend import R1csFile, WtnsFile, compile_r1cs_to_gkr
    from gkr_tpu_torch.recursion.circom_interp import ConstraintFailure, run_circuit
    from gkr_tpu_torch.recursion.native import (ConstraintBuilder, proof_shape,
                                                verify_gkr_gadget)
    from gkr_tpu_torch.recursion.serialize import (CircomInputProof, get_meta,
                                                   modify_proof_for_circom,
                                                   write_aggregated_input)
    from gkr_tpu_torch.recursion.templating import modify_circom_file, structural_lens
    from gkr_tpu_torch.spec import prove_spec

    fix = os.path.join("tests", "fixtures", "circom_mimc")
    circuits, ws, _ = compile_r1cs_to_gkr(R1csFile.read(os.path.join(fix, "circuit.r1cs")),
                                          WtnsFile.read(os.path.join(fix, "witness.wtns")))
    toy = GKRCircuit([GateLayer(1, 2, mult_gates=[(0, 0, 1), (1, 2, 3)]),
                      GateLayer(2, 2, mult_gates=[(0, 0, 0), (1, 1, 1), (2, 1, 2),
                                                  (3, 3, 3)])], input_k=2)
    user = os.path.join("examples", "mimc")
    include = [os.path.join("gkr_tpu_torch", "circuits")]
    for label, circuit, w in (("circom_mimc subcircuit 0", circuits[0], ws[0]),
                              ("toy circuit", toy, toy.evaluate([3, 2, 3, 1]))):
        K.reset_launches()
        proof, dt = sync_time(lambda: prove(circuit, w, backend=TorchBackend(
            device=DEVICE, host_threshold=0)))
        counts = launched(K)
        missing = [k for k in ("phase1_partials", "phase2_partials", "round_tail",
                               "fold") if not counts.get(k)]
        if missing:
            raise AssertionError(f"{label}: no {missing} launched: {counts}")
        if proof != prove_spec(circuit, w):
            raise AssertionError(f"{label}: the card's proof differs from prove_spec's")
        print(f"  {label} (k = {circuit.k_list()}): proved on the card in {dt:.3f} s "
              f"with host_threshold 0, launches {counts}; equal to the port's "
              f"prove_spec", flush=True)
        metas = get_meta([proof])
        d = os.path.join(tmp, label.split()[0])
        os.makedirs(d)
        strong = modify_circom_file(os.path.join(user, "circuit.circom"), metas,
                                    os.path.join(d, "strong.circom"),
                                    lens=structural_lens([proof]))
        weak = modify_circom_file(os.path.join(user, "circuit.circom"), metas,
                                  os.path.join(d, "weak.circom"))

        def verdicts(padded, tag):
            path = write_aggregated_input(os.path.join(user, "input1.json"),
                                          [CircomInputProof(padded)],
                                          os.path.join(d, f"agg_{tag}.json"))
            with open(path) as f:
                inputs = json.load(f)
            out = {}
            for name, text in (("strong circuit", strong), ("weak circuit", weak)):
                try:
                    run_circuit(text, json.loads(json.dumps(inputs)), include_dirs=include)
                    out[name] = True
                except ConstraintFailure:
                    out[name] = False
            for name, full in (("strong gadget", True), ("weak gadget", False)):
                try:
                    verify_gkr_gadget(ConstraintBuilder(), padded, metas[0],
                                      circuit=circuit if full else None, full_fs=full,
                                      shape=proof_shape(proof) if full else None)
                    out[name] = True
                except AssertionError:
                    out[name] = False
            return out

        honest = verdicts(modify_proof_for_circom([proof], metas)[0], "honest")
        if not all(honest.values()):
            raise AssertionError(f"{label}: the honest card proof was rejected: {honest}")
        rows = []
        for field, tamper in TAMPERS.items():
            padded = modify_proof_for_circom([proof], metas)[0]
            target = {"coeffs": padded.sumcheck_proofs, "d": padded.d}.get(field)
            if target is not None and not (target and target[0]):
                rows.append(f"{field}: no rows to tamper")
                continue
            tamper(padded, P)
            v = verdicts(padded, field)
            if v["strong circuit"] or v["strong gadget"]:
                raise AssertionError(f"{label}: a strong executor accepted tampered "
                                     f"{field}: {v}")
            if v["weak circuit"] != v["weak gadget"]:
                raise AssertionError(f"{label}: the weak executors disagree on "
                                     f"tampered {field}: {v}")
            rows.append(f"{field}: strong both reject, weak both "
                        f"{'accept' if v['weak gadget'] else 'reject'}")
        print(f"    honest proof: accepted by all four executors; "
              + "; ".join(rows), flush=True)


NATIVE_VALUES = 4096             # [15]: values the library's entry points are held on
NATIVE_HASH_LISTS = 1000         # [15]: random lists NativeMimc7 is held on


def same_terms(a, b) -> bool:
    """Two sparse forms hold the same rows (lazy SparseMle compared by their
    arrays, without materialising 2^20 rows)."""
    if hasattr(a, "_mon") and hasattr(b, "_mon"):
        return (np.array_equal(a._mon, b._mon)
                and np.array_equal(a._limbs, b._limbs))
    return list(a) == list(b)


def phase_native(K, P, verify, circuit, w, proof, bench_line: dict, cli_dir: str,
                 build_s: float, name_power: str) -> None:
    """The native host engine (`gkr_tpu_torch.native`): its entry points
    against the port's Python field and mle, NativeMimc7 against Mimc7,
    CppBackend against the card on the bench's 2^20 layer and on [5]'s
    prove, --backend cpp on [10]'s export, verify with the native and the
    Python transcript, the two Moebius transforms, and [8]'s baseline."""
    import random
    from gkr_tpu_torch import TorchBackend, bench, cli, native, prove
    from gkr_tpu_torch.mimc import Mimc7
    from gkr_tpu_torch.mle import eq_table, mobius
    from gkr_tpu_torch.native import engine as E

    L = native.lib()
    threads = L.gkr_num_threads()
    cxx = subprocess.run([native.CXX, "--version"], capture_output=True, text=True,
                         check=True).stdout.splitlines()[0]
    host = (f"{native.cpu_model()}, {os.cpu_count()} cores, {threads} OpenMP threads "
            f"(torch.get_num_threads() {torch.get_num_threads()})")
    print(f"  {cxx}; {' '.join(native.CXX_FLAGS)}; built in [2] in {build_s:.2f} s; "
          f"host {host}; card {name_power}", flush=True)

    # the entry points against the Python field and mle
    rng = random.Random(15)
    edges = [0, 1, 2, P - 2, P - 1]
    xs = edges + [rng.randrange(P) for _ in range(NATIVE_VALUES - len(edges))]
    ys = xs[::-1]
    buf = E._buf
    a, b = E.ints_to_buf(xs), E.ints_to_buf(ys)
    out = bytearray(len(a))
    L.gkr_batch_mul(buf(a), buf(b), buf(out), len(xs))
    if E.buf_to_ints(out) != [x * y % P for x, y in zip(xs, ys)]:
        raise AssertionError("gkr_batch_mul differs from the Python field")
    L.gkr_batch_add(buf(a), buf(b), buf(out), len(xs))
    if E.buf_to_ints(out) != [(x + y) % P for x, y in zip(xs, ys)]:
        raise AssertionError("gkr_batch_add differs from the Python field")
    m = bytearray(a)
    L.gkr_to_mont(buf(m), len(xs))
    if E.buf_to_ints(m) != [x * 2 ** 256 % P for x in xs]:
        raise AssertionError("gkr_to_mont differs from x * 2^256 mod p")
    L.gkr_from_mont(buf(m), len(xs))
    if E.buf_to_ints(m) != xs:
        raise AssertionError("gkr_from_mont does not invert gkr_to_mont")
    point = xs[:12]
    z = E.ints_to_buf(point)
    L.gkr_to_mont(buf(z), len(point))
    table = bytearray(32 << len(point))
    L.gkr_eq_table(buf(z), len(point), buf(table))
    L.gkr_from_mont(buf(table), 1 << len(point))
    if E.buf_to_ints(table) != eq_table(point):
        raise AssertionError("gkr_eq_table differs from mle.eq_table")
    L.gkr_mobius(buf(a), len(xs))
    if E.buf_to_ints(a) != mobius(xs):
        raise AssertionError("gkr_mobius differs from mle.mobius")
    print(f"  gkr_batch_mul, gkr_batch_add, gkr_to_mont / gkr_from_mont, gkr_mobius "
          f"on {len(xs)} values (0, 1, p - 1 among them) and gkr_eq_table on "
          f"{len(point)} coordinates: equal to the Python field and mle", flush=True)
    native_hash, py_hash = E.NativeMimc7(), Mimc7()
    for _ in range(NATIVE_HASH_LISTS):
        arr = [rng.choice(edges) if rng.random() < 0.1 else rng.randrange(P)
               for _ in range(rng.randrange(1, 5))]
        if native_hash.multi_hash(arr, 0) != py_hash.multi_hash(arr, 0):
            raise AssertionError(f"NativeMimc7 differs from Mimc7 on {arr}")
    print(f"  NativeMimc7 equal to Mimc7 on {NATIVE_HASH_LISTS} random lists of 1-4 "
          "elements", flush=True)

    # the bench's 2^20 layer: C++ against the card
    k = bench.LAYER_K
    z, wl, ag, mg, kc, struct = bench.synth_layer(random.Random(1), k)
    got, dt_cpp = sync_time(lambda: E.CppBackend().layer_sumcheck(
        z, wl, ag, mg, kc, k, struct, Mimc7()))
    card = TorchBackend()
    card.layer_sumcheck(z, wl, ag, mg, kc, k, struct, Mimc7(), layer_idx=1)
    want, dt_card = sync_time(lambda: card.layer_sumcheck(   # witness, plan cached
        z, wl, ag, mg, kc, k, struct, Mimc7(), layer_idx=1))
    if got != want:
        raise AssertionError("CppBackend's 2^20 layer transcript differs from the card's")
    print(f"  the bench's 2^{k} layer: CppBackend's {2 * k} round polynomials and "
          f"challenges equal the card's; C++ {dt_cpp:.3f} s ({(1 << k) / dt_cpp:.1f} "
          f"gates/s; {host}), card {dt_card:.3f} s (fused, witness packed and plan "
          f"cached; {name_power}); host clock with a synchronize", flush=True)

    # the full prove of [5]'s circuit on the C++ engine
    cpp_backend = E.CppBackend()
    cpp_proof, dt_prove, stages = stage_time(
        lambda: prove(circuit, w, backend=cpp_backend))
    stages = ", ".join(f"{n} {t:.3f}" for n, t in stages.items())
    if json.dumps(cpp_proof.to_dict()) != json.dumps(proof.to_dict()):
        raise AssertionError("the C++ proof of synth_circuit(20, 16) differs from [5]'s")
    print(f"  prove(synth_circuit(20, 16), CppBackend()): {dt_prove:.3f} s ({stages} s; "
          f"{host}); byte-equal to [5]'s card proof", flush=True)
    ok, dt_native = sync_time(lambda: verify(cpp_proof, circuit))
    if not ok:
        raise AssertionError("verify rejected the C++ proof")
    ok, dt_python = sync_time(lambda: verify(proof, circuit, transcript=Mimc7()))
    if not ok:
        raise AssertionError("verify with an explicit Mimc7() rejected [5]'s proof")
    print(f"  verify of that proof (= [5]'s): {dt_native:.3f} s with the native "
          f"transcript, {dt_python:.3f} s with an explicit Mimc7() (host clock)",
          flush=True)

    # --backend cpp on [10]'s export
    agg = os.path.join(cli_dir, "aggregated")
    r1cs, wtns = agg + ".r1cs", agg + ".wtns"
    cpp_json = os.path.join(cli_dir, "proofs_cpp.json")
    argv = ["prove-r1cs", "--r1cs", r1cs, "--wtns", wtns, "--backend", "cpp",
            "-o", cpp_json]
    print(f"  python -m gkr_tpu_torch {' '.join(argv)}", flush=True)
    K.reset_launches()
    (rc, _), dt = sync_time(lambda: run_cli(cli, argv))
    if rc != 0:
        raise AssertionError(f"prove-r1cs --backend cpp exited {rc}")
    with open(cpp_json, "rb") as f, open(os.path.join(cli_dir, "proofs.json"), "rb") as g:
        if f.read() != g.read():
            raise AssertionError("prove-r1cs --backend cpp differs from --backend torch")
    rc, out = run_cli(cli, ["verify", "--proof", cpp_json, "--r1cs", r1cs, "--wtns", wtns])
    n = check_verify_output(rc, out)
    print(f"  prove-r1cs --backend cpp: exit 0, {dt:.3f} s, launches {launched(K)}; "
          f"its proofs.json equals --backend torch's byte for byte; verify: all {n} "
          "subcircuits OK, exit 0", flush=True)

    # the 2^20 table's sparse form: Moebius on the card against C++
    table = w[1]
    card.sparse_from_dense(table)
    E.sparse_from_dense_native(table)
    dev, dt_dev = sync_time(lambda: card.sparse_from_dense(table))
    host_sp, dt_host = sync_time(lambda: E.sparse_from_dense_native(table))
    if not same_terms(dev, host_sp):
        raise AssertionError("the card's and the C++ sparse forms of the 2^20 table differ")
    print(f"  sparse_from_dense of one 2^{len(table).bit_length() - 1} table "
          f"({len(dev)} terms): TorchBackend {dt_dev:.3f} s ({name_power}), "
          f"sparse_from_dense_native {dt_host:.3f} s ({host}); equal rows; host "
          "clock, warm", flush=True)

    # [8]'s bench line
    cpp_rate = bench_line["cpp_gates_per_sec"]
    if cpp_rate is None or bench_line["cpp_measured_at"] != f"2^{k}":
        raise AssertionError(f"bench line: cpp {cpp_rate} at "
                             f"{bench_line['cpp_measured_at']}")
    if abs(bench_line["vs_baseline"] - bench_line["value"] / cpp_rate) > 0.0051:
        raise AssertionError(f"bench vs_baseline {bench_line['vs_baseline']} is not "
                             f"value / cpp_gates_per_sec")
    print(f"  [8]'s bench line: cpp_gates_per_sec {cpp_rate} at "
          f"{bench_line['cpp_measured_at']}, vs_baseline {bench_line['vs_baseline']} "
          f"= value {bench_line['value']} / cpp_gates_per_sec; baseline "
          f"'{bench_line['baseline']}'", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from gkr_tpu_torch import (TorchBackend, bench, native, probes, prove,
                               prove_pipelined, verify)
    from gkr_tpu_torch.circuit import synth_circuit
    from gkr_tpu_torch.field import P, R
    from gkr_tpu_torch.mimc import Mimc7
    from gkr_tpu_torch.mle import mle_struct
    from gkr_tpu_torch.sumcheck import prove_layer_sumcheck
    from gkr_tpu_torch.torcheng import fused as F
    from gkr_tpu_torch.torcheng import kernels as K
    from gkr_tpu_torch.torcheng import limbs as L

    name_power = smi("name,power.limit")
    sm_clock_hz = peak_clock_hz()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"[1] card: {name_power}; max SM clock {max_sm_clock_hz() / 1e6:.0f} MHz, "
          f"a spin reads {spin_clock_hz()[0] / 1e6:.1f} MHz: peaks at "
          f"{sm_clock_hz / 1e6:.1f} MHz; "
          f"torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"{kind} x {count}", flush=True)

    print("[2] build", flush=True)
    t0 = time.perf_counter()
    K.library_path().unlink(missing_ok=True)    # built anew, so ptxas reports
    path = K.build()
    print(f"  {path.name}: {time.perf_counter() - t0:.2f} s", flush=True)
    native.library_path().unlink(missing_ok=True)   # built anew, and timed
    t0 = time.perf_counter()
    native.lib()
    native_build_s = time.perf_counter() - t0
    print(f"  {native.library_path().name} (g++, the native host engine): "
          f"{native_build_s:.2f} s", flush=True)
    ptxas = ptxas_report(K.BUILD_LOG)
    for name, props in ptxas.items():
        print(f"  ptxas: {name}:{props}", flush=True)
    kernel_report(K, ptxas)
    sass = probes.probe_sass()
    print(f"  SASS: {sass}", flush=True)
    if sass["peak_imad_per_rep"] != K.CHAINS:
        raise AssertionError(f"the peak chain issues {sass['peak_imad_per_rep']} IMADs "
                             f"a repetition, not {K.CHAINS}: the compiler folded it")
    imad_per_product = sass["price_per_mont_mul"]
    print("  a Montgomery product's SASS, by variant (depth 9 less depth 1, block "
          "256, over 8): IMAD without moves / IMAD.WIDE / IMAD.HI / DFMA / FP64 "
          "pipe / instructions -> floor in IMAD slots "
          f"(IMAD.WIDE at {probes.IMAD_WIDE_PASSES} pass, IMAD.HI at "
          f"{probes.IMAD_HI_PASSES}):", flush=True)
    for v in K.MONT_VARIANTS:
        print(f"    {v:7s} " + " / ".join(f"{sass[f'{key}_per_mont_mul_{v}']:g}" for key in
                                       ("imad", "wide", "hi", "dfma", "fp64", "instr"))
              + f" -> {sass[f'floor_per_mont_mul_{v}']:g}", flush=True)

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
          "max abs limb error 0, unless stated)", flush=True)
    imad_rate = peak_per_s(IMAD_PER_SM_CLOCK)
    fp32_rate = peak_per_s(FP32_PER_SM_CLOCK)
    measured = probes.measure_vpu_peak() * 1e9          # raises above 1.02 x peak
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"  IMAD rate: peak probe reads {measured / 1e12:.3f} T/s (marginal), "
          f"{measured / imad_rate:.4f} of the card's {sms} SMs x {IMAD_PER_SM_CLOCK} "
          f"x peak SM clock = {imad_rate / 1e12:.3f} T/s", flush=True)
    print(f"  bounds: {imad_per_product:g} IMAD slots a Montgomery product (the least "
          f"IMAD count of the integer variants, {sass['imad_per_mont_mul']:g}, lowered "
          f"to the FP64 variant's floor where that is lower) at the card's "
          f"{imad_rate / 1e12:.3f} T/s", flush=True)
    rows, record, bound = phase_kernels(K, L, P, R, sm_clock_hz, imad_rate,
                                        imad_per_product)
    phase_fused_kernels(K, L, F, P, R, Mimc7, record, bound, circuit)
    phase_probe_kernels(K, L, probes, P, R, record, imad_rate, fp32_rate, sass)

    print("[4] per-round slice: prove(synth_circuit(20, 16), "
          "TorchBackend(fused=False))", flush=True)
    per_round, _, wall_pr = phase_slice(K, prove, verify, TorchBackend(fused=False),
                                        circuit, w, EXPECTED_PER_ROUND)
    print("[4b] where the per-round prove's device time goes (torch.profiler)",
          flush=True)
    phase_profile(prove, lambda: TorchBackend(fused=False), circuit, w, wall_pr)

    print("[5] fused slice: prove(synth_circuit(20, 16), TorchBackend())",
          flush=True)
    backend = TorchBackend()
    fused, proof, wall_f = phase_slice(K, prove, verify, backend, circuit, w,
                                       EXPECTED_FUSED)
    again, wall_warm, stages = stage_time(lambda: prove(circuit, w, backend=backend))
    if again != proof:
        raise AssertionError("a second fused proof of the circuit differs")
    print(f"  second prove, same backend (wiring plans cached): {wall_warm:.3f} s",
          flush=True)
    for name, sec in stages.items():
        print(f"    {name}: {sec:.3f} s", flush=True)
    print("[5b] where the fused prove's device time goes, plans cached "
          "(torch.profiler)", flush=True)
    device_ms = phase_profile(prove, lambda: backend, circuit, w, wall_warm)
    eval_totals_vs_bounds(K, circuit, bound, device_ms)
    eq_total_vs_bound(circuit, bound, device_ms)
    print(f"  fused prove {wall_f:.3f} s (plans built), {wall_warm:.3f} s "
          f"(cached), against per-round {wall_pr:.3f} s (host clock, this run)",
          flush=True)

    print("[6] card against CPU", flush=True)
    phase_card_vs_cpu(F, prove, verify, TorchBackend, synth_circuit, mle_struct,
                      prove_layer_sumcheck, Mimc7, P)

    print("[7] pipelined slice: prove_pipelined(synth_circuit(20, 16))", flush=True)
    pipelined, wall_pipe = phase_pipelined(K, F, prove_pipelined, verify, backend,
                                           circuit, w, proof, fused)
    print(f"  pipelined prove {wall_pipe:.3f} s against the fused prove's "
          f"{wall_warm:.3f} s, plans cached (host clock, this run)", flush=True)
    del backend              # circuit, w and [5]'s proof stay for [12]

    print("[8] the port bench: gkr_tpu_torch.bench.main(), k = 20", flush=True)
    from_probes, bench_line = phase_bench(K, bench)

    print("[9] the probe commands: python -m gkr_tpu_torch.probes micro, tune",
          flush=True)
    from_probes.update(phase_probe_paths(K, probes))

    cli_dir = tempfile.TemporaryDirectory(prefix="gkr_cli_")    # [15] reads it too
    print("[10] the CLI flow on the card: python -m gkr_tpu_torch prove-native "
          "(square, weak gadget, 3 inputs), prove-r1cs, verify", flush=True)
    phase_cli_flow(K, P, cli_dir.name)
    with tempfile.TemporaryDirectory(prefix="gkr_agg_") as tmp:
        print("[11] the full-strength aggregation: prove-native --example mimc "
              "--backend torch --export agg over examples/mimc/input1, input2; "
              "prove-r1cs and verify of the export", flush=True)
        phase_aggregation(K, tmp)

    print("[12] the multi-device engine: synth_circuit(20, 16) on the CLI's path, "
          "--backend sharded --devices D (ShardedBackend(make_mesh(devices=[cuda:0] "
          "* D))) through prove_subcircuits, D = 2 and 8", flush=True)
    sharded_warm = phase_sharded(K, P, verify, circuit, w, proof, wall_warm, name_power)
    with tempfile.TemporaryDirectory(prefix="gkr_exec_") as tmp:
        print("[13] the executors on card proofs: the interpreter (VerifyGKR, "
              "VerifyGKRStrongFS) and verify_gkr_gadget, honest and tampered", flush=True)
        phase_executors(K, P, tmp)
    with tempfile.TemporaryDirectory(prefix="gkr_multihost_") as tmp:
        print("[14] the multi-controller path: 2 ranks (torch.distributed, gloo) on "
              "cuda:0, synth_circuit(20, 16) through ShardedBackend(make_mesh(hosts=2)) "
              "at 1 and 4 shards a rank; the hot bucket in rank 1; the scaling and "
              "subcircuits twins", flush=True)
        phase_multihost(P, verify, circuit, proof, wall_warm, sharded_warm, name_power,
                        tmp)
    print("[15] the native host engine: gkr_tpu_torch.native (csrc/gkrhost.cpp, "
          "C++ and OpenMP), CppBackend against the card, --backend cpp, the "
          "native transcript and Moebius, the bench's C++ baseline", flush=True)
    phase_native(K, P, verify, circuit, w, proof, bench_line, cli_dir.name,
                 native_build_s, name_power)
    cli_dir.cleanup()
    del circuit, w, proof

    for row in rows:
        src = (per_round if row["name"] in LAUNCHES_FROM_PER_ROUND
               else pipelined if row["name"] in LAUNCHES_FROM_PIPELINED
               else from_probes if row["name"] in LAUNCHES_FROM_PROBES else fused)
        row["launches"] = src.get(row["name"], 0)
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} was not launched on its path")
    print(json.dumps({"kernels": rows}))
    print(name_power)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
