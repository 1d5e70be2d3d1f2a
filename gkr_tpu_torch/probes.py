"""Probes of the card: the integer-multiply rate, the serial MiMC latency,
the per-op costs and the Montgomery-product variants.

The twins of the JAX package's bench probes (`bench.py`
`_measure_vpu_peak`, `_measure_hash_latency`; `scripts/micro_vpu.py`;
`scripts/tune_pallas_mul.py`), on one NVIDIA card through the kernels of
`csrc/probes.cu` (wrappers in `torcheng/kernels.py`).  Every time is taken
with CUDA events (the SM clock check also with the host clock); nothing
here runs without a card.

    python -m gkr_tpu_torch.probes micro   # the SM clock; ms and Gop/s of 7 u32/i32/f32 ops
    python -m gkr_tpu_torch.probes tune    # Montgomery variants x block widths,
                                           # and each variant's one-thread latency

`measure_vpu_peak` and `measure_hash_latency` anchor the port bench's
roofline (`gkr_tpu_torch.bench`).

`sass_counts` reads the compiled kernels' SASS (`cuobjdump`), so that a
rate can be checked against the instructions the card really issues: a
multiply chain the compiler folded would show fewer IMADs than products.
A marginal rate above CEILING x the card's peak for its op (the SMs x the
op's rate an SM a clock x `peak_clock_hz`) raises: it is a folded chain,
not a fast card.
"""

from __future__ import annotations

import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from collections import Counter
from functools import lru_cache

import numpy as np
import torch

from .field import P
from .torcheng import kernels as K
from .torcheng import limbs as L

ROWS, COLS = 16, 1 << 20            # the probes' (16, 2^20) words
N_MONT = 1 << 20                    # the Montgomery chain's elements
HASH_DEPTHS = (2, 10)               # the MiMC chain's two depths (bench.py)
IMAD_PER_SM_CLOCK = 64              # sm_90: 32-bit integer multiply-adds an SM a clock
FP32_PER_SM_CLOCK = 128             # sm_90: f32 multiplies or FMAs an SM a clock
FP64_PER_SM_CLOCK = 64              # sm_90: f64 FMAs or adds an SM a clock
INSTR_PER_SM_CLOCK = 128            # instructions an SM a clock: 4 sub-partitions x 32 lanes
IMAD_WIDE_PASSES = 1                # IMAD-pipe passes of an IMAD.WIDE (PERF.md section 6)
IMAD_HI_PASSES = 2                  # of an IMAD.HI: half the IMAD rate, measured
# Each micro op's peak, operations an SM a clock, for the one instruction a
# repetition its SASS holds: an IMAD for the integer multiplies (u32_mul16's
# masks issue beside it on another pipe), one 64-a-clock integer instruction
# for the shift-add, an IADD3 of two adds for u32_add, FMUL/FFMA for f32.
OP_PER_SM_CLOCK = {"u32_add": 2 * 64, "u32_mul": IMAD_PER_SM_CLOCK,
                   "u32_mul16": IMAD_PER_SM_CLOCK, "u32_shift": 64,
                   "i32_mul": IMAD_PER_SM_CLOCK, "f32_mul": FP32_PER_SM_CLOCK,
                   "f32_fma": FP32_PER_SM_CLOCK}
CEILING = 1.02                      # a marginal rate above CEILING x peak raises
MARGINAL_ROUNDS = 3                 # alternating lo/hi timings a marginal reading


def require_card() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probes measure the card")
    return torch.device("cuda")


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


def queued_ms(fn, iters: int) -> float:
    """Mean milliseconds of fn() on the card with its launches back to back:
    a spin (torch.cuda._sleep) holds the stream while the host enqueues
    them, so the host's time to launch does not pad kernels shorter than it
    (a one-thread chain of a few products takes microseconds)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    enqueue_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * enqueue_s * peak_clock_hz()) + 10**6)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def marginal_ms(lo, hi, iters: int) -> float:
    """Milliseconds of hi() beyond lo(): the median over MARGINAL_ROUNDS of
    the two timed back to back (`iters` calls each, after one warm call), so
    that a drift of the card's clock falls on both."""
    return statistics.median(event_ms(hi, iters, 1) - event_ms(lo, iters, 1)
                             for _ in range(MARGINAL_ROUNDS))


@lru_cache(maxsize=None)
def max_sm_clock_hz() -> float:
    """The card's max SM clock, as nvidia-smi reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.split()[0]) * 1e6


def spin_clock_hz(cycles: int = 10**8) -> tuple[float, float]:
    """The SM clock as CUDA events and as the host clock see it: a spin of
    `cycles` SM clock ticks (torch.cuda._sleep) over its time by each."""
    ms = event_ms(lambda: torch.cuda._sleep(cycles), 3, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(cycles)
    torch.cuda.synchronize()
    return cycles / (ms * 1e-3), cycles / (time.perf_counter() - t0)


@lru_cache(maxsize=None)
def peak_clock_hz() -> float:
    """The SM clock the card's peaks take: the larger of nvidia-smi's max
    and a spin's reading by CUDA events, since some cards run above the max
    they report (1994 MHz against 1980 on one H100)."""
    return max(max_sm_clock_hz(), spin_clock_hz()[0])


def peak_per_s(per_sm_clock: int) -> float:
    """Operations a second of the card at `per_sm_clock` an SM a clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * per_sm_clock * peak_clock_hz()


def check_ceiling(what: str, rate: float, peak: float) -> None:
    if rate > CEILING * peak:
        raise RuntimeError(f"{what}: {rate / 1e9:.1f} Gop/s read, above {CEILING} x "
                           f"the card's {peak / 1e9:.1f}: a folded chain")


# ------------------------------------------------------------------ inputs

def peak_inputs(device, seed: int = 0):
    """(16, 2^20) u32 words in [1, 2^15), as bench.py's probe draws them."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.integers(1, 1 << 15, size=(ROWS, COLS),
                                      dtype=np.int32)).to(device)
    return a, a


def micro_inputs(op: str, device, seed: int = 0, shape=None):
    """scripts/micro_vpu.py's operands, (16, 2^20) unless `shape` says
    otherwise: a uniform in [0, 1) and b = a + 0.5 for f32; a in [1, 2^15)
    and b = a + 3 for u32 and i32."""
    rng = np.random.default_rng(seed)
    shape = (ROWS, COLS) if shape is None else shape
    if op.startswith("f32"):
        a = rng.random(size=shape, dtype=np.float32)
        b = a + np.float32(0.5)
    else:
        a = rng.integers(1, 1 << 15, size=shape, dtype=np.int32)
        b = a + 3
    return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


def mont_inputs(device, seed: int = 0, n: int | None = None):
    """Two (n, 16) tables (n = 2^20 unless given) of canonical values below
    p, as 16-bit limbs (top limb below 0x3000, as
    scripts/tune_pallas_mul.py draws them); b is a's rows reversed."""
    rng = np.random.default_rng(seed)
    n = N_MONT if n is None else n
    a = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.int32)
    a[:, 15] &= 0x2FFF
    return (torch.from_numpy(a).to(device),
            torch.from_numpy(a[::-1].copy()).to(device))


# -------------------------------------------------------------------- SASS

def _demangle(sym: str) -> str:
    """_Z12k_mont_chainILi0ELi9ELi256EEvPKjS1_Pjx -> k_mont_chain<0,9,256>
    (the names of probes.cu's kernels: an identifier and int arguments)."""
    m = re.match(r"_Z(\d+)", sym)
    if not m:
        return sym
    start = m.end()
    name = sym[start:start + int(m.group(1))]
    args = re.match(r"I((?:Li-?\d+E)+)E", sym[start + len(name):])
    if not args:
        return name
    return f"{name}<{','.join(re.findall(r'Li(-?\d+)E', args.group(1)))}>"


def sass_counts(path) -> dict[str, Counter]:
    """Opcode counts of every kernel in a shared library, by demangled
    name, from `cuobjdump -sass`."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                         text=True, check=True).stdout
    counts: dict[str, Counter] = {}
    cur = None
    for line in out.splitlines():
        f = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if f:
            cur = counts.setdefault(_demangle(f.group(1)), Counter())
            continue
        op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if op and cur is not None:
            cur[op.group(1)] += 1
    return counts


def imads(c: Counter) -> int:
    """Multiplies and multiply-adds of the IMAD family, without the register
    moves (IMAD.MOV) the compiler issues on the same pipe."""
    return sum(v for k, v in c.items()
               if k.startswith("IMAD") and not k.startswith("IMAD.MOV"))


def wide_imads(c: Counter) -> int:
    """32x32->64-bit multiplies (IMAD.WIDE), the family member that one
    thread's dependent chain of Montgomery products pays most for."""
    return sum(v for k, v in c.items() if k.startswith("IMAD.WIDE"))


def hi_imads(c: Counter) -> int:
    """High halves of 32x32-bit products (IMAD.HI)."""
    return sum(v for k, v in c.items() if k.startswith("IMAD.HI"))


def fp64_ops(c: Counter) -> int:
    """Instructions of the FP64 pipe: DFMA, DADD, DMUL."""
    return sum(v for k, v in c.items() if k.startswith(("DFMA", "DADD", "DMUL")))


def dfmas(c: Counter) -> int:
    """Double-precision FMAs (DFMA, DFMA.RZ)."""
    return sum(v for k, v in c.items() if k.startswith("DFMA"))


def product_floor(per: dict) -> float:
    """A product's floor in IMAD slots (one slot: 1/64 of an SM clock) from
    its per-product SASS counts: its busiest resource -- the IMAD pipe
    (64 an SM a clock, IMAD.WIDE and IMAD.HI at their passes), the FP64
    pipe (64) or instruction issue (INSTR_PER_SM_CLOCK)."""
    imad_pipe = (per["imad"] + (IMAD_WIDE_PASSES - 1) * per["wide"]
                 + (IMAD_HI_PASSES - 1) * per["hi"])
    return max(imad_pipe, per["fp64"] * IMAD_PER_SM_CLOCK / FP64_PER_SM_CLOCK,
               per["instr"] * IMAD_PER_SM_CLOCK / INSTR_PER_SM_CLOCK)


def sass_summary(counts: dict[str, Counter]) -> dict:
    """What the probes' SASS says: IMADs a repetition of the peak chain
    (8 products expected); a Montgomery product of each variant (IMADs
    without moves, of them IMAD.WIDE and IMAD.HI, DFMAs, FP64-pipe
    instructions, all instructions, and its floor); instructions a
    repetition of each micro op.  The compute bounds take one count a
    product, `price_per_mont_mul`, in IMAD slots: `imad_per_mont_mul`, the
    least IMAD count of the integer variants, lowered to the floor of a
    variant on the FP64 pipe (`product_floor`) where that is lower -- a
    count of IMADs alone would price such a variant near zero."""
    lo, hi = (counts[f"k_u32_mul_chain<{r}>"] for r in K.CHAIN_REPS)
    out = {"peak_imad_per_rep": (imads(hi) - imads(lo))
           / (K.CHAIN_REPS[1] - K.CHAIN_REPS[0])}
    d0, d1 = K.MONT_DEPTHS
    for v, name in enumerate(K.MONT_VARIANTS):
        a, b = (counts[f"k_mont_chain<{v},{d},256>"] for d in (d0, d1))
        per = {key: (fn(b) - fn(a)) / (d1 - d0) for key, fn in (
            ("imad", imads), ("wide", wide_imads), ("hi", hi_imads),
            ("dfma", dfmas), ("fp64", fp64_ops),
            ("instr", lambda c: sum(c.values())))}
        for key, x in per.items():
            out[f"{key}_per_mont_mul_{name}"] = x
        out[f"floor_per_mont_mul_{name}"] = product_floor(per)
    out["imad_per_mont_mul"] = min(out[f"imad_per_mont_mul_{v}"] for v in K.MONT_VARIANTS
                                   if v not in K.MONT_FP64)
    out["price_per_mont_mul"] = min([out["imad_per_mont_mul"]]
                                    + [out[f"floor_per_mont_mul_{v}"] for v in K.MONT_FP64])
    _, r0, r1 = K.MICRO_REPS
    for i, op in enumerate(K.MICRO_OPS):
        a, b = (counts[f"k_micro_op<{i},{r}>"] for r in (r0, r1))
        out[f"instr_per_rep_{op}"] = (sum(b.values()) - sum(a.values())) / (r1 - r0)
    return out


def probe_sass() -> dict:
    """`sass_summary` of the built library."""
    return sass_summary(sass_counts(K.build()))


def check_bound(what: str, ms: float, bound_ms: float) -> None:
    """A kernel's reading against its bound: faster than CEILING x the
    bound's rate means the bound is wrong (it counted work the card did not
    do, or priced it above the card's peak)."""
    if bound_ms > CEILING * ms:
        raise RuntimeError(f"{what}: {ms:.4f} ms read, below its bound of "
                           f"{bound_ms:.4f} ms / {CEILING}: the bound is wrong")


# ------------------------------------------------------------------ probes

def measure_vpu_peak() -> float:
    """The card's 32-bit integer multiply rate, Gop/s: the marginal rate of
    the u32 multiply chain between 16 and 128 products an accumulator (8
    accumulators an element, (16, 2^20) elements), which cancels the launch
    and memory cost.  Raises if the marginal time is not positive, or if
    the rate is above CEILING x the card's IMAD peak."""
    dev = require_card()
    a, b = peak_inputs(dev)
    lo_r, hi_r = K.CHAIN_REPS
    dt = marginal_ms(lambda: K.u32_mul_chain(a, b, lo_r),
                     lambda: K.u32_mul_chain(a, b, hi_r), 20)
    if dt <= 0:
        raise RuntimeError("u32 peak unmeasurable (marginal time <= 0)")
    rate = a.numel() * (hi_r - lo_r) * K.CHAINS / (dt * 1e-3)
    check_ceiling("u32 multiply chain", rate, peak_per_s(IMAD_PER_SM_CLOCK))
    return rate / 1e9


def measure_hash_latency() -> float:
    """Seconds of one 3-element MiMC7-91 multi_hash on the card: the
    marginal time of a dependent chain h <- H(h, a, b) between depths 2
    and 10 (every hash waits for the last).  Raises if it is not
    positive."""
    import random

    dev = require_card()
    rng = random.Random(9)
    a, b, h0 = (L.pack_scalar(rng.randrange(P), dev) for _ in range(3))

    def chain(depth):
        h = h0
        for _ in range(depth):
            h = K.mimc_multi(torch.stack([h, a, b]))
        return h

    lo_d, hi_d = HASH_DEPTHS
    dt = marginal_ms(lambda: chain(lo_d), lambda: chain(hi_d), 3) / (hi_d - lo_d) * 1e-3
    if dt <= 0:
        raise RuntimeError("hash latency unmeasurable (marginal time <= 0)")
    return dt


def micro(iters: int = 20) -> list[dict]:
    """Each op of `kernels.MICRO_OPS` at (16, 2^20): its time and rate at 16
    repetitions (scripts/micro_vpu.py's measurement, bound by the memory
    traffic), and its marginal rate between 1040 and 4112 repetitions,
    where the instructions bind; a marginal rate above CEILING x the op's
    peak (OP_PER_SM_CLOCK) raises.  The kernel is first held to its plain
    version at 16 repetitions (integers bit-exact, f32 within a relative
    16 * 2^-22: see chip_smoke.py)."""
    dev = require_card()
    rows = []
    r16, r0, r1 = K.MICRO_REPS
    for op in K.MICRO_OPS:
        a, b = micro_inputs(op, dev)
        got, want = K.micro_op(op, a, b, r16), K.micro_op_plain(op, a, b, r16)
        ok = (torch.allclose(got, want, rtol=r16 * 2.0 ** -22, atol=0)
              if op.startswith("f32") else torch.equal(got, want))
        if not ok:
            raise AssertionError(f"micro_op {op}: kernel disagrees with its plain version")
        t16 = event_ms(lambda: K.micro_op(op, a, b, r16), iters)
        dt = marginal_ms(lambda: K.micro_op(op, a, b, r0),
                         lambda: K.micro_op(op, a, b, r1), iters)
        ops = a.numel()
        marginal = ops * (r1 - r0) / (dt * 1e-3) if dt > 0 else None
        if marginal is not None:
            check_ceiling(f"micro_op {op}", marginal, peak_per_s(OP_PER_SM_CLOCK[op]))
        rows.append({"op": op, "ms": t16, "gops": ops * r16 / t16 / 1e6,
                     "marginal_gops": None if marginal is None else marginal / 1e9,
                     "peak_gops": peak_per_s(OP_PER_SM_CLOCK[op]) / 1e9})
    return rows


def product_latency_ns(variant: str, iters: int = 200) -> float:
    """Nanoseconds of one dependent Montgomery product of `variant` in one
    thread: the `mont_chain` kernel at one element, the median over
    MARGINAL_ROUNDS of its marginal time between depths 1 and 9, launches
    queued back to back (`queued_ms`).  Raises if it is not positive."""
    dev = require_card()
    a, b = mont_inputs(dev, n=1)
    d0, d1 = K.MONT_DEPTHS
    ms = statistics.median(
        queued_ms(lambda: K.mont_chain(a, b, d1, variant), iters)
        - queued_ms(lambda: K.mont_chain(a, b, d0, variant), iters)
        for _ in range(MARGINAL_ROUNDS)) / (d1 - d0)
    if ms <= 0:
        raise RuntimeError(f"{variant}: product latency unmeasurable (marginal <= 0)")
    return ms * 1e6


def tune(iters: int = 10) -> list[dict]:
    """Each Montgomery variant at each block width on 2^20 elements: depth 1
    must be bit-equal to the `mont_mul` kernel first; then the marginal
    ms a pass between depths 1 and 9 (the product's cost without the
    memory traffic) and the products a second it gives; beside them the
    variant's latency of one dependent product in one thread, in ns and SM
    clocks (`product_latency_ns` at `peak_clock_hz`)."""
    dev = require_card()
    a, b = mont_inputs(dev)
    ref = K.mont_mul(a, b)
    d0, d1 = K.MONT_DEPTHS
    rows = []
    for variant in K.MONT_VARIANTS:
        lat_ns = product_latency_ns(variant)
        for block in K.MONT_BLOCKS:
            if not torch.equal(K.mont_chain(a, b, d0, variant, block), ref):
                raise AssertionError(f"mont_chain {variant}/{block}: depth 1 differs "
                                     f"from mont_mul")
            t0 = event_ms(lambda: K.mont_chain(a, b, d0, variant, block), iters)
            per = marginal_ms(lambda: K.mont_chain(a, b, d0, variant, block),
                              lambda: K.mont_chain(a, b, d1, variant, block),
                              iters) / (d1 - d0)
            rows.append({"variant": variant, "block": block, "ms_depth1": t0,
                         "ms_per_pass": per,
                         "mmul_per_sec": N_MONT / (per * 1e-3) if per > 0 else None,
                         "latency_ns": lat_ns,
                         "latency_clocks": lat_ns * 1e-9 * peak_clock_hz()})
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cmd = argv[0] if argv else None
    if cmd not in ("micro", "tune"):
        print("usage: python -m gkr_tpu_torch.probes micro|tune", file=sys.stderr)
        return 2
    require_card()
    print(f"card: {torch.cuda.get_device_name(0)}", flush=True)
    if cmd == "micro":
        by_events, by_host = spin_clock_hz()
        print(f"SM clock under a spin: {by_events / 1e6:.1f} MHz by CUDA events, "
              f"{by_host / 1e6:.1f} MHz by the host clock (max "
              f"{max_sm_clock_hz() / 1e6:.0f} MHz)", flush=True)
        for r in micro():
            mg = "unmeasurable" if r["marginal_gops"] is None else f"{r['marginal_gops']:8.1f}"
            print(f"{r['op']:10s} {r['ms']:8.4f} ms  {r['gops']:8.1f} Gop/s  "
                  f"marginal {mg} Gop/s (card's peak {r['peak_gops']:.1f})", flush=True)
    else:
        for r in tune():
            rate = ("unmeasurable" if r["mmul_per_sec"] is None
                    else f"{r['mmul_per_sec'] / 1e6:8.1f} M muls/s")
            print(f"{r['variant']:7s} block={r['block']:5d}: depth 1 {r['ms_depth1']:.4f} ms, "
                  f"{r['ms_per_pass']:.4f} ms/mul-pass  {rate}; one thread: "
                  f"{r['latency_ns']:.1f} ns = {r['latency_clocks']:.0f} SM clocks "
                  f"a dependent product", flush=True)
    key = "instr_per_rep" if cmd == "micro" else "per_mont_mul"
    print("SASS: " + ", ".join(f"{k} {v:g}" for k, v in probe_sass().items()
                               if key in k), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
