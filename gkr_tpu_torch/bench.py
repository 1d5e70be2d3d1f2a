"""The port bench: the GKR layer sumcheck at a 2^k-gate layer (k = LAYER_K
= 20) on one NVIDIA card, the twin of the JAX package's `bench.py`.

    python -m gkr_tpu_torch.bench                      # one JSON line
    GKR_BENCH_EXTRA=1 python -m gkr_tpu_torch.bench    # + a 2^16 layer, the
                                                       #   full prove, a 2^24
                                                       #   layer, the native
                                                       #   aggregation

It proves the same layer and circuit as `bench.py` (the same generators and
seeds) and prints ONE JSON line with `bench.py`'s field names:

  metric / value / unit    fused engine, gates/s of one 2^k-gate layer, steady
                           state (witness packed, wiring plan cached)
  vs_baseline              value / host_py_gates_per_sec: the port has no
                           C++ engine, so the baseline is the host Python
                           engine at 2^HOST_K (12); cpp_* are null
  pipelined_*              a batch of 6 instances of the layer with one
                           download for the batch; per-layer amortised ms
  layer_ms, sumcheck_rounds_per_sec, fr_mle_evals_per_sec, mont_mul_per_sec
                           as bench.py counts them (`work`)
  kernel_peak_mul_per_sec  the `mont_mul` kernel alone, chained on (2^20, 16)
  sol_fraction             mont_mul_per_sec / kernel_peak_mul_per_sec
  roofline                 hbm_min_ms (bench.py's byte model at the card's
                           memory rate), vpu_min_ms (the layer's Montgomery
                           products x the price of one product in the
                           probes' SASS, `probes.sass_summary`, in IMAD
                           slots, at the card's IMAD peak),
                           serial_fs_min_ms (the 2k round hashes' dependent
                           products at one slot a clock of one thread),
                           chip_min_ms (their max), sol_vs_chip (chip_min_ms
                           / layer_ms); beside them the readings the floors
                           do not use: the peak probe's IMAD rate and the
                           `mimc_multi` kernel's hash latency (2k of them:
                           serial_fs_measured_ms).  Null on a card whose
                           memory rate is not on record, with the reason
  breakdown_ms             the two builds and the rest (rounds and hashes)
  sync_rtt_ms              one tiny kernel and a synchronize
  extra.aggregation_e2e    (GKR_BENCH_EXTRA=1) the full-strength native
                           aggregation of examples/mimc/input{1,2,3}.json:
                           total_s, round_s, constraints as bench.py's, and
                           stage_s (`run_aggregation`; each stage's line on
                           stderr as it ends)

Every time is on the card, ending in `torch.cuda.synchronize()`.  Failures
propagate: a failed check raises, and a sol_vs_chip above 1.05 (a time below
the card's floor) is refused.  The entry point raises without a card; the
functions take `device=` so the tests can run them on the CPU.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time
from pathlib import Path

import torch

from . import probes
from .circuit import GateLayer, GKRCircuit
from .examples import mimc_example
from .field import P
from .mimc import Mimc7
from .mle import MleStruct
from .prover import prove
from .recursion import aggregator, native
from .sumcheck import prove_layer_sumcheck, round_poly_len
from .torcheng import fused as F
from .torcheng import kernels as K
from .torcheng import limbs as L
from .torcheng.backend import TorchBackend, prove_pipelined
from .verifier import verify

# Device memory rate, GB/s, by device name prefix (the SXM part's data sheet)
HBM_GBPS = {"NVIDIA H100 80GB HBM3": 3350.0}
SOL_LIMIT = 1.05                 # sol_vs_chip above this is an impossible reading
PIPELINE_BATCH = 6
LAYER_K = 20                     # the headline layer: 2^LAYER_K gates
HOST_K = 12                      # the host engine's layer (the baseline)
FULL_K, FULL_KIN = 20, 16        # extra.full_prove: 2^20-gate layers, 2^16 inputs
TOP_K = 24                       # extra's largest layer


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _stderr(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def _seconds(fn, device) -> float:
    t0 = time.perf_counter()
    fn()
    _sync(device)
    return time.perf_counter() - t0


def _best(fn, device, reps: int = 3) -> float:
    return min(_seconds(fn, device) for _ in range(reps))


# ------------------------------------------------------------- generators

def synth_layer(rng: random.Random, k: int, k_cur: int = 4):
    """bench.py's layer: 2^k gates over 2^k_cur outputs, half add and half
    mult, random inputs from rng; full support."""
    n = 1 << k
    w_values = [rng.randrange(P) for _ in range(n)]
    add_gates = []
    mult_gates = []
    for g in range(n):
        o = g & ((1 << k_cur) - 1)
        trip = (o, rng.randrange(n), rng.randrange(n))
        (add_gates if g & 1 else mult_gates).append(trip)
    z = [rng.randrange(P) for _ in range(k_cur)]
    struct = MleStruct(k, False, [True] * k, k)
    return z, w_values, add_gates, mult_gates, k_cur, struct


def synth_circuit(rng: random.Random, k: int, k_input: int) -> GKRCircuit:
    """bench.py's depth-3 circuit: 16 outputs <- 2^k gates <- 2^k-entry
    layer <- 2^k gates <- 2^k_input inputs."""
    n, ni = 1 << k, 1 << k_input
    l0 = GateLayer(4, k, add_gates=[(o, rng.randrange(n), rng.randrange(n))
                                    for o in range(16)])
    mid_add, mid_mult = [], []
    for g in range(n):
        trip = (g, rng.randrange(n), rng.randrange(n))
        (mid_add if g & 1 else mid_mult).append(trip)
    l1 = GateLayer(k, k, add_gates=mid_add, mult_gates=mid_mult)
    in_add, in_mult = [], []
    for g in range(n):
        trip = (g & (n - 1), rng.randrange(ni), rng.randrange(ni))
        (in_add if g & 1 else in_mult).append(trip)
    l2 = GateLayer(k, k_input, add_gates=in_add, mult_gates=in_mult)
    return GKRCircuit(layers=[l0, l1, l2], input_k=k_input)


# ----------------------------------------------------------- accounting

def work(n: int) -> tuple[int, int]:
    """bench.py's per-layer work: table entries the round evaluations read
    (4 tables in phase 1, 3 in phase 2, halving) and Montgomery products
    (evaluations and folds: 3.5 m in phase 1, 4.5 m in phase 2)."""
    entries = 0
    for phase_tables in (4, 3):
        m = n
        while m >= 2:
            entries += m * phase_tables
            m //= 2
    mont_muls = 0
    m = n
    while m >= 2:
        mont_muls += int(3.5 * m) + int(4.5 * m)
        m //= 2
    return entries, mont_muls


def _min_hbm_bytes(n: int, na: int, nm: int) -> int:
    """bench.py's analytic minimum device-memory traffic of one fused layer
    (bytes), 64 B an element: the rounds read each stack twice and write
    half of it (4 tables in phase 1, 3 in phase 2); the builds gather, multiply
    and sum over the gates and pass over the n buckets."""
    G = na + nm
    elem = 64
    rounds = 0
    for t in (4, 3):
        per_entry = elem * t
        rounds += 2 * n * per_entry
        rounds += 2 * n * per_entry
        rounds += n * per_entry
    builds = 0
    for _phase in (1, 2):
        builds += 3 * elem * G
        builds += 2 * 128 * G
        builds += 2 * 128 * n
        builds += elem * n * 3
    return rounds + builds


# ----------------------------------------------------------------- runs

def run_host(k: int) -> float:
    """Gates/s of the host Python engine on bench.py's 2^k layer."""
    rng = random.Random(1)
    z, w, ag, mg, kc, struct = synth_layer(rng, k)
    t0 = time.perf_counter()
    prove_layer_sumcheck(z, w, ag, mg, kc, k, struct, Mimc7())
    return (len(ag) + len(mg)) / (time.perf_counter() - t0)


def run_device(k: int, breakdown: bool = True, device="cuda", reps: int = 3):
    """Seconds of one fused layer sumcheck of bench.py's 2^k layer (best of
    `reps` after a warm-up, witness packed and wiring plan cached, download
    and host check included), and of its two builds alone (None without
    `breakdown`)."""
    rng = random.Random(1)
    z, w, ag, mg, kc, struct = synth_layer(rng, k)
    w_dev = L.pack(w, device)
    wiring = F.build_wiring(ag, mg, 1 << k, device)

    def one():
        return F.prove_layer_sumcheck_fused(z, w, ag, mg, kc, k, struct, Mimc7(),
                                            w_dev=w_dev, wiring=wiring,
                                            device=device)

    one()                                       # warm-up
    best = _best(one, device, reps)
    if not breakdown:
        return best, None, None
    z_dev = L.pack(z, device).reshape(kc, 16)
    b1 = _best(lambda: F._build_phase1(w_dev, z_dev, wiring), device, reps)
    _, eqz = F._build_phase1(w_dev, z_dev, wiring)
    b_star = L.pack([rng.randrange(P) for _ in range(k)], device).reshape(k, 16)
    wb = L.pack_scalar(rng.randrange(P), device)
    b2 = _best(lambda: F._build_phase2(w_dev, b_star, wb, eqz, wiring), device, reps)
    return best, b1, b2


def run_kernel_peak(n: int | None = None) -> float:
    """Products a second of the `mont_mul` kernel alone, chained x = x * a
    on (n, 16) limbs (n = 2^20 unless given), by CUDA events."""
    dev = probes.require_card()
    a, _ = probes.mont_inputs(dev, n=n)
    n = a.shape[0]
    depth = 10

    def chain():
        x = a
        for _ in range(depth):
            x = K.mont_mul(x, a)

    return n * depth / (probes.event_ms(chain, 3) * 1e-3)


def run_device_pipelined(k: int, batch: int = PIPELINE_BATCH, device="cuda"):
    """`batch` instances of bench.py's layer (distinct z) enqueued back to
    back with one download for the batch, then every host check: (gates/s,
    seconds a layer), best of 3."""
    rng = random.Random(1)
    _z0, w, ag, mg, kc, struct = synth_layer(rng, k)
    n = 1 << k
    w_dev = L.pack(w, device)
    wiring = F.build_wiring(ag, mg, n, device)
    z_list = [[rng.randrange(P) for _ in range(kc)] for _ in range(batch)]

    def run():
        outs = [F.prove_layer_sumcheck_fused(
            z, w, ag, mg, kc, k, struct, Mimc7(), w_dev=w_dev, wiring=wiring,
            defer=True, device=device) for z in z_list]
        host = F.download([a for arrays, _ in outs for a in arrays])
        for i, (arrays, finish) in enumerate(outs):
            finish(host[len(arrays) * i:len(arrays) * (i + 1)])

    run()                                       # warm-up
    best = _best(run, device)
    return batch * n / best, best / batch


class _TimedBackend:
    """Per-stage host-clock timing around a prover backend, each stage
    ending in a device synchronize."""

    def __init__(self, inner: TorchBackend):
        self.inner = inner
        self.t: dict[str, float] = {}

    def reset_cache(self):
        self.inner.reset_cache()

    def _timed(self, name, fn, *a, **kw):
        t0 = time.perf_counter()
        r = fn(*a, **kw)
        _sync(self.inner.device)
        self.t[name] = self.t.get(name, 0.0) + (time.perf_counter() - t0)
        return r

    def mle_struct(self, *a, **kw):
        return self._timed("mle_struct", self.inner.mle_struct, *a, **kw)

    def layer_sumcheck(self, *a, **kw):
        return self._timed("sumcheck", self.inner.layer_sumcheck, *a, **kw)

    def restrict_to_line(self, *a, **kw):
        return self._timed("restrict_to_line", self.inner.restrict_to_line, *a, **kw)

    def sparse_from_dense(self, *a, **kw):
        return self._timed("sparse_from_dense", self.inner.sparse_from_dense, *a, **kw)


def run_full_prove(k: int, k_input: int = 16, device="cuda"):
    """`prove()` of bench.py's circuit (after one warm-up proof that builds
    the wiring plans), the port's verify of it, and `prove_pipelined` of the
    same circuit, whose proof must equal it.  Returns (total gates, prove
    seconds, per-stage seconds, verify seconds, pipelined seconds)."""
    rng = random.Random(7)
    circuit = synth_circuit(rng, k, k_input)
    inputs = [rng.randrange(P) for _ in range(1 << k_input)]
    w = circuit.evaluate(inputs)
    backend = _TimedBackend(TorchBackend(device=device))
    prove(circuit, w, backend=backend)          # warm-up: wiring plans
    backend.t.clear()
    t0 = time.perf_counter()
    proof = prove(circuit, w, backend=backend)
    dt = time.perf_counter() - t0
    t1 = time.perf_counter()
    if not verify(proof, circuit):
        raise RuntimeError("full-prove self-verification failed")
    verify_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    p2 = prove_pipelined(circuit, w, backend=backend.inner)
    pipe_s = time.perf_counter() - t2
    if p2 != proof:     # equal to a verified proof: it verifies too
        raise RuntimeError("the pipelined proof differs from prove()'s")
    gates = sum(layer.n_gates() for layer in circuit.layers)
    return gates, dt, dict(backend.t), verify_s, pipe_s


STAGES = ("gadget build", "compile", "prove", "self-verify")


def aggregation_round(user_fn, user_input: dict, previous=None, backend=None,
                      device=None, log=None):
    """`native.prove_round_native` with its defaults, stage by stage:
    `build_round_native`, `compile_round_native` (width 1),
    `prove_subcircuits` without its self-verify, then the port's verifier
    on each proof, each stage ending in a device synchronize.  Returns
    (the round's (proof, circuit) pairs, its builder, a dict of each
    stage's host-clock seconds, `total`, `constraints` and the kernel
    launches of the round).  Launch counts are exact only when nothing
    else launches meanwhile.  `log` gets one line as each stage ends, so a
    run cut short says how far it got."""
    dev = torch.device("cuda" if device is None else device)
    log = log or (lambda line: None)
    st = {}

    def stage(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        _sync(dev)
        st[name] = time.perf_counter() - t0
        log(f"  {name}: {st[name]:.3f} s")
        return out

    K.reset_launches()
    b = stage("gadget build", native.build_round_native, user_fn, user_input,
              previous)
    circuits, ws = stage("compile", native.compile_round_native, b)
    proofs = stage("prove", aggregator.prove_subcircuits, circuits, ws,
                   backend=backend, check_verify=False)
    good = stage("self-verify", lambda: all(verify(p, c) for p, c in
                                            zip(proofs, circuits)))
    if not good:
        raise RuntimeError("aggregation round: self-verification failed")
    st.update(total=sum(st[k] for k in STAGES), constraints=len(b.constraints),
              launches={k: v for k, v in K.LAUNCHES.items() if v})
    return list(zip(proofs, circuits)), b, st


def run_aggregation(n_inputs: int = 3, device=None, log=None) -> dict:
    """Native aggregation end to end, bench.py's `aggregation_e2e` cell: the
    committed mimc inputs (examples/mimc/input*.json), full-strength
    defaults (full_fs + recombination + each round's self-verify), one
    TorchBackend (`device=None`: the card).  Round i's constraint count
    includes the in-circuit verifier gadget for round i-1's proof;
    `stage_s` splits each round by `aggregation_round`, which passes `log`
    a line as each stage ends.  Host clock; a failure propagates."""
    root = Path(__file__).resolve().parent.parent / "examples" / "mimc"
    inputs = []
    for i in range(1, n_inputs + 1):
        with open(root / f"input{i}.json") as f:
            inputs.append({k: int(v) for k, v in json.load(f).items()})
    log = log or (lambda line: None)
    backend = TorchBackend(device=device)
    pairs, rounds = None, []
    t_all = time.perf_counter()
    for i, ui in enumerate(inputs):
        log(f"round {i}: started")
        pairs, _, st = aggregation_round(mimc_example, ui, pairs, backend,
                                         device, log)
        rounds.append(st)
        log(f"round {i}: {st['total']:.3f} s, {st['constraints']} constraints")
    return {
        "config": (f"native mimc aggregation, {n_inputs} inputs, full_fs "
                   "+ recombination + self-verify, TorchBackend"),
        "total_s": round(time.perf_counter() - t_all, 2),
        "round_s": [round(st["total"], 3) for st in rounds],
        "constraints": [st["constraints"] for st in rounds],
        "stage_s": [{k: round(st[k], 3) for k in STAGES} for st in rounds],
    }


def sync_rtt_s() -> float:
    """One tiny kernel and a synchronize, best of 5."""
    x = torch.zeros(16, dtype=torch.int32, device="cuda")
    return _best(lambda: x.add_(1), "cuda", reps=5)


def card_label() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def hashed_elements(k: int) -> int:
    """Field elements the 2k round hashes of bench.py's 2^k layer take:
    each round's 2 or 3 coefficients (full support, both gate kinds)."""
    v = 2 * k
    return sum(round_poly_len(j, v, [True] * k, True, True) for j in range(1, v + 1))


def roofline(dt: float, n: int, mont_muls: int) -> tuple[dict | None, str | None]:
    """The card's floor for one layer against its measured time: (roofline,
    None), or (None, the reason) for a card whose memory rate is not on
    record.  Raises on an impossible reading (sol_vs_chip > 1.05).

    The floors are the card's: its memory rate, its IMAD peak, and one
    thread issuing one IMAD a clock through the rounds' dependent MiMC
    products (4 a hash round an element).  The probes' readings of the
    IMAD rate and the hash latency are reported beside them."""
    kind = torch.cuda.get_device_name(0)
    gbps = next((g for pfx, g in HBM_GBPS.items() if kind.startswith(pfx)), None)
    if gbps is None:
        return None, f"no device-memory rate on record for {kind!r}"
    k = n.bit_length() - 1
    vpu_gops = probes.measure_vpu_peak()
    t_hash = probes.measure_hash_latency()
    sass = probes.probe_sass()
    price = sass["price_per_mont_mul"]
    imad_peak = probes.peak_per_s(probes.IMAD_PER_SM_CLOCK)
    serial_products = 4 * K.MIMC_ROUNDS * hashed_elements(k)
    hbm_min = _min_hbm_bytes(n, n // 2, n // 2) / (gbps * 1e9)
    vpu_min = mont_muls * price / imad_peak
    serial_min = serial_products * price / probes.peak_clock_hz()
    chip_min = max(hbm_min, vpu_min, serial_min)
    sol = chip_min / dt
    if sol > SOL_LIMIT:
        raise RuntimeError(f"impossible reading: the layer took {dt * 1e3:.3f} ms, "
                           f"below the card's floor of {chip_min * 1e3:.3f} ms")
    return {
        "device_kind": kind,
        "hbm_gbps": gbps,
        "vpu_u32_gops_peak": round(imad_peak / 1e9, 1),
        "vpu_u32_gops_measured": round(vpu_gops, 1),
        "imad_per_mont_mul_sass": sass["imad_per_mont_mul"],
        "price_per_mont_mul_sass": price,
        "t_hash_ms_measured": round(t_hash * 1e3, 4),
        "hbm_min_ms": round(hbm_min * 1e3, 3),
        "vpu_min_ms": round(vpu_min * 1e3, 3),
        "serial_fs_min_ms": round(serial_min * 1e3, 3),
        "serial_fs_measured_ms": round(2 * k * t_hash * 1e3, 3),
        "chip_min_ms": round(chip_min * 1e3, 3),
        "sol_vs_chip": round(sol, 4),
    }, None


def main() -> dict:
    """Run the bench on the card and print its JSON line; returns it."""
    probes.require_card()
    k, host_k = LAYER_K, HOST_K
    n = 1 << k
    v = 2 * k
    out = {"metric": f"gkr_layer_sumcheck_2e{k}_gates_per_sec", "unit": "gates/s"}
    dt, b1, b2 = run_device(k)
    device_rate = n / dt
    peak = run_kernel_peak()
    host_rate = run_host(host_k)
    entries, mont_muls = work(n)
    roof, reason = roofline(dt, n, mont_muls)
    rtt = sync_rtt_s()
    pipe_rate, pipe_layer_s = run_device_pipelined(k)
    out.update({
        "value": round(device_rate, 1),
        "vs_baseline": round(device_rate / host_rate, 2),
        "baseline": f"host Python engine at 2^{host_k} (the port has no C++ engine)",
        "pipelined_gates_per_sec": round(pipe_rate, 1),
        "pipelined_layer_ms": round(pipe_layer_s * 1e3, 2),
        "cpp_gates_per_sec": None,
        "cpp_measured_at": None,
        "host_cpus": os.cpu_count(),
        "sync_rtt_ms": round(rtt * 1e3, 4),
        "host_py_gates_per_sec": round(host_rate, 1),
        "layer_ms": round(dt * 1e3, 2),
        "sumcheck_rounds_per_sec": round(v / dt, 1),
        "fr_mle_evals_per_sec": round(entries / dt, 1),
        "mont_mul_per_sec": round(mont_muls / dt, 1),
        "kernel_peak_mul_per_sec": round(peak, 1),
        "sol_fraction": round(mont_muls / dt / peak, 4),
        "roofline": roof,
        "breakdown_ms": {"build_phase1": round(b1 * 1e3, 2),
                         "build_phase2": round(b2 * 1e3, 2),
                         "rounds_and_hash": round((dt - b1 - b2) * 1e3, 2)},
        "card": card_label(),
    })
    if reason is not None:
        out["roofline_reason"] = reason
    if os.environ.get("GKR_BENCH_EXTRA", "") == "1":
        extra = {}
        dt16, _, _ = run_device(16, breakdown=False)
        extra["layer_2e16"] = {"gates_per_sec": round((1 << 16) / dt16, 1),
                               "layer_ms": round(dt16 * 1e3, 3)}
        gates, fdt, stages, verify_s, pipe_s = run_full_prove(FULL_K, FULL_KIN)
        extra["full_prove"] = {
            "config": f"depth-3, 2^{FULL_K}-gate layers, 2^{FULL_KIN} inputs",
            "total_gates": gates,
            "prove_s": round(fdt, 3),
            "gates_per_sec": round(gates / fdt, 1),
            "stage_s": {s: round(t, 3) for s, t in stages.items()},
            "host_verify_s": round(verify_s, 2),
            "pipelined_prove_s": round(pipe_s, 3),
            "pipelined_gates_per_sec": round(gates / pipe_s, 1),
        }
        dt_top, _, _ = run_device(TOP_K, breakdown=False)
        extra[f"layer_2e{TOP_K}"] = {"gates_per_sec": round((1 << TOP_K) / dt_top, 1),
                                     "layer_ms": round(dt_top * 1e3, 2)}
        # last: its third round's pure-Python gadget build has not finished
        # in 30 minutes on the H100's host (PERF.md §5)
        extra["aggregation_e2e"] = run_aggregation(log=_stderr)
        out["extra"] = extra
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
