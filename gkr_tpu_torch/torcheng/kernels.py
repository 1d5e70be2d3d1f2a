"""The layer sumcheck's CUDA kernels and the bench's probe kernels, with
their plain versions.

Each prover wrapper takes int32 limb tensors (see `limbs`); the probe
wrappers (`u32_mul_chain`, `micro_op`, `mont_chain`, at the end) take 32-bit
words.  For a tensor on the CPU a wrapper runs the plain PyTorch version
beside it; for a CUDA tensor it launches the kernel from `csrc/kernels.cu`
or `csrc/probes.cu` or raises -- there is no fallback.  Each launch adds one
to `LAUNCHES[name]`.

The kernels are compiled from the sources in the checkout at first use
(one `nvcc` for sm_90a into one plain-C shared library, loaded with
ctypes), into `_build/` beside this package, keyed by a hash of the
sources.  Importing this module needs neither `nvcc` nor a card.

Bounds below are for one H100 SXM (3.35 TB/s; 132 SMs x 64 32-bit IMAD per
clock) at the layer engines' shapes, n = 2^20 entries, 64 B an element.
A Montgomery product is priced at the least IMAD count of the integer
variants' SASS, moves left out, lowered to the FP64 variant's floor where
that is lower (`probes.sass_summary`, as `chip_smoke.py` prints it): 151.625,
the count of `fr_mul` (cc: CIOS with its carries in PTX multiply-adds, 317
instructions a product), against 232.125 for the 8 x 32-bit CIOS
`fr_mul_cios32` and 170.875 for the hash's `fr_mul_lat`; the FP64
product `fr_mul_f64` issues 30 IMADs and 159.5 FP64 instructions, 393 in
all, a floor of 196.5 slots.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from functools import lru_cache
from pathlib import Path

import torch

from ..mimc import Mimc7, mimc7_constants
from . import limbs as L

N_LIMBS = 16
THREADS = 256
EVAL_TILE = 128              # entries of an eval tile (csrc EVAL_TILE, checked at load)
EVAL_MAX_BLOCKS = 132        # the eval kernels' persistent grid: one block an H100 SM
TAIL_MAX_G = 1024            # partials a round_tail takes at most (csrc TAIL_MAX_G)
SEG_LIMBS = 18               # limbs of a relaxed segment sum (csrc SEG_LIMBS)
MIMC_ROUNDS = 91             # the device MiMC's constant table

LAUNCHES = {"mont_mul": 0, "fold": 0, "phase1_eval": 0, "phase2_eval": 0,
            "phase1_partials": 0, "phase2_partials": 0, "round_tail": 0,
            "mimc_multi": 0, "eq_table": 0, "seg_sum": 0, "normalize": 0,
            "normalize_mul": 0, "stack": 0, "u32_mul_chain": 0, "micro_op": 0,
            "mont_chain_cios32": 0, "mont_chain_school": 0, "mont_chain_lat": 0,
            "mont_chain_f64": 0, "mont_chain_cc": 0}

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# The prover's kernels and the bench's probes (both include fr.cuh), built
# into one shared library by one nvcc.
SOURCES = ("kernels.cu", "probes.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
_LOAD_LOCK = threading.Lock()   # the aggregator's threads share one library
BUILD_LOG = ""

# Argument types of each C launcher: v pointer, l long long, i int
_SIGNATURES = {
    "gkr_mont_mul": "vvvllv",
    "gkr_fold": "vvvlv",
    "gkr_phase_eval": "ivvvlivvv",
    "gkr_eval_attrs": "iv",
    "gkr_eq_table": "vivv",
    "gkr_seg_sum": "vvvvliv",
    "gkr_normalize": "vivvlv",
    "gkr_round_tail": "viivivvv",
    "gkr_mimc_multi": "vivivv",
    "gkr_stack": "vvvvivlv",
    "gkr_u32_mul_chain": "vvvliv",
    "gkr_micro_op": "vvvliiv",
    "gkr_mont_chain": "vvvliiiv",
}
_CTYPES = {"v": ctypes.c_void_p, "l": ctypes.c_longlong, "i": ctypes.c_int}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -------------------------------------------------------------------- build

def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in ("fr.cuh", *SOURCES):
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libgkrfr-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/ into the shared library unless it is already built.
    Raises on a failed build; the compiler's report lands in BUILD_LOG."""
    global BUILD_LOG
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC / src) for src in SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG = res.stdout + res.stderr
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{BUILD_LOG}")
    os.replace(tmp, out)
    return out


def _load():
    """The kernels, built and loaded at first use, by one thread at a time."""
    global _lib
    if _lib is None:
        with _LOAD_LOCK:
            if _lib is None:
                _lib = _load_library()
    return _lib


def _load_library():
    lib = ctypes.CDLL(str(build()))
    for name, sig in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = [_CTYPES[c] for c in sig]
        fn.restype = ctypes.c_int
    tile = _eval_attrs(lib, 4)["tile"]
    if tile != EVAL_TILE:       # _block_sums_plain's schedule reads EVAL_TILE
        raise RuntimeError(f"the library's eval tile is {tile} entries, "
                           f"EVAL_TILE {EVAL_TILE}")
    return lib


def _check_limbs(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    for t in ts:
        if t.dtype != L.LIMB_DTYPE or t.shape[-1] != N_LIMBS:
            raise ValueError(f"expected int32 (..., 16) limbs, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _launch(name: str, device: torch.device, fn, *args) -> None:
    """Call a C launcher on the device's current stream; raise on a CUDA
    error."""
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1


def _ptr(t: torch.Tensor) -> int:
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError("kernel operands must be contiguous and 16-byte aligned")
    return t.data_ptr()


# ----------------------------------------------------------------- mont_mul
# Replaces pallas_kernels.pl_mont_mul_T / pl_mont_mul
# (gkr_tpu/jaxeng/pallas_kernels.py:157, :175).  One thread an element.
# Bound at n = 2^20: 201 MB moved (a, b, out) = 60 us at 3.35 TB/s, against
# 2.8e8 IMAD = 17 us at 1.98 GHz: bytes bind.  The design reads and writes
# each element once as four 16-byte vectors and keeps the whole product in
# registers.

PLAIN_CHUNK = 1 << 18        # rows per pass: bounds the (rows, 16, 16) products


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    n = a.numel() // N_LIMBS
    m = b.numel() // N_LIMBS
    a2 = a.reshape(n, N_LIMBS)
    b2 = b.reshape(m, 1, N_LIMBS).expand(m, n // m, N_LIMBS).reshape(n, N_LIMBS)
    out = torch.empty_like(a2)
    for s in range(0, n, PLAIN_CHUNK):
        out[s:s + PLAIN_CHUNK] = L.redc(L.conv_columns(a2[s:s + PLAIN_CHUNK],
                                                       b2[s:s + PLAIN_CHUNK]))
    return out.reshape(a.shape)


def _normalize_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """(..., <=32) int64 relaxed limbs -> canonical Montgomery, no kernel."""
    return mont_mul_plain(L.redc(x), L.const("R2_LIMBS", x.device))


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a * b / R mod p of (..., 16) limbs.

    b holds m rows, m dividing a's row count n; row i of a is multiplied by
    row i // (n / m) of b: m = n is elementwise, m = 1 a scalar for all, and
    a (npts, half, 16) a with (npts, 16) b multiplies each point's run."""
    dev = _check_limbs(a, b)
    n = a.numel() // N_LIMBS
    m = b.numel() // N_LIMBS
    if m == 0 or n % m:
        raise ValueError(f"b's {m} rows do not divide a's {n}")
    if dev.type == "cpu":
        return mont_mul_plain(a, b)
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    if n:
        lib = _load()
        _launch("mont_mul", dev, lib.gkr_mont_mul, _ptr(a), _ptr(b), _ptr(out),
                n, n // m)
    return out


# --------------------------------------------------------------------- fold
# Replaces pallas_kernels.pl_fold (gkr_tpu/jaxeng/pallas_kernels.py:251),
# reached through pl_fold_rep.  The table halves every round, so no
# replicated buffer and no 2^-j rescale.  Bound for the (2^20, 4) phase-1
# stack: 268 MB read + 134 MB written = 120 us, against 5.5e8 IMAD = 33 us:
# bytes bind.  One thread an output element; r is read from device memory.

def fold_plain(S: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    half = S.shape[0] // 2
    lo, hi = S[:half], S[half:]
    return L.add_mod(lo, mont_mul_plain(L.sub_mod(hi, lo), r))


def fold(S: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Bind the MSB variable of the stacked tables S (n, T, 16) at r (16,):
    lo + r * (hi - lo), lo = S[:n/2], hi = S[n/2:] -> (n/2, T, 16)."""
    dev = _check_limbs(S, r)
    if r.numel() != N_LIMBS or S.shape[0] % 2:
        raise ValueError(f"fold of {tuple(S.shape)} at r {tuple(r.shape)}")
    if dev.type == "cpu":
        return fold_plain(S, r)
    S, r = S.contiguous(), r.contiguous()
    out = torch.empty((S.shape[0] // 2,) + tuple(S.shape[1:]),
                      dtype=S.dtype, device=dev)
    m = out.numel() // N_LIMBS
    if m:
        lib = _load()
        _launch("fold", dev, lib.gkr_fold, _ptr(S), _ptr(r), _ptr(out), m)
    return out


# ------------------------------------------------------------- phase evals
# Replace pallas_kernels.pl_phase1_partials / pl_phase2_partials
# (gkr_tpu/jaxeng/pallas_kernels.py:406, :428), the fused engine's per-block
# round sums, and pl_phase1_eval / pl_phase2_eval (:318, :368), the
# per-round engine's round sums, with one kernel template (csrc k_eval<4>,
# k_eval<3>).  Bounds at n = 2^20: phase 1 reads 268 MB = 80 us, against
# 3 * 2^19 products = 2.4e8 IMAD slots = 14 us; phase 2 reads 201 MB =
# 60 us, against 3 * 2^19 products (and 3 a block by wb) = 14 us.  Both
# bind on bytes, but a product takes 1.6x (`fr_mul`, cc) to 1.8x (cios32)
# its IMAD count's time even at full occupancy, so the products must run
# under the loads on enough warps.
# The design: tile k is entries [k TILE, (k+1) TILE) of lo and of hi, two
# contiguous byte ranges; a persistent grid of one block an SM (G <= 132)
# walks the tiles k = b, b + G, ...; a three-stage ring in shared memory
# (16-byte cp.async copies, coalesced, at a padded pitch so that reads are
# free of bank conflicts) loads the next tiles while the block computes on
# this one, three threads an entry, one point t = 0, 1, 2 each (12 warps an
# SM).  Phase 2 takes three products an entry instead of the JAX formula's
# six: sum_s FA_t (wb + W_t) + FMwb_t W_t = wb sum_s FA_t + sum_s W_t (FA_t
# + FMwb_t), and one more product by wb a block and t.  The sums are lazy
# (9-word accumulators, warp shuffles, one reduction mod p a block), and
# each block writes a canonical (3, 16) partial.  `phase*_partials` hand
# the G partials to `round_tail`; `phase*_eval` is the same launch, whose
# last block (an atomic ticket, one counter a stream, reset by that block)
# sums them into y (3, 16).  The plain versions keep the JAX formulas, so
# the card's bit-equal check also proves the factorisation.


def _eval_grid(half: int) -> int:
    return max(1, min(EVAL_MAX_BLOCKS, -(-half // EVAL_TILE)))


def _phase1_terms_plain(S: torch.Tensor) -> torch.Tensor:
    """(n, 4, 16) -> (3, n/2, 16): (HA1_t + HM_t) * W_t + HA2_t per entry at
    t = 0, 1, 2."""
    X = torch.stack(L.eval3_halves(S))
    w, ha1, ha2, hm = X[:, :, 0], X[:, :, 1], X[:, :, 2], X[:, :, 3]
    return L.add_mod(mont_mul_plain(L.add_mod(ha1, hm), w), ha2)


def _phase2_terms_plain(S: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """(n, 3, 16) -> (3, n/2, 16): FA_t * (wb + W_t) + FMwb_t * W_t."""
    X = torch.stack(L.eval3_halves(S))
    w, fa, fmwb = X[:, :, 0], X[:, :, 1], X[:, :, 2]
    return L.add_mod(mont_mul_plain(fa, L.add_mod(wb, w)), mont_mul_plain(fmwb, w))


def _block_sums_plain(terms: torch.Tensor) -> torch.Tensor:
    """(3, half, 16) canonical terms -> (G, 3, 16): the sum mod p of the
    entries each block of the eval kernels' grid takes (entry s is in tile
    s // EVAL_TILE, which goes to block (s // EVAL_TILE) % G)."""
    half = terms.shape[1]
    grid = _eval_grid(half)
    blk = (torch.arange(half, device=terms.device) // EVAL_TILE) % grid
    acc = torch.zeros((grid, 3, N_LIMBS), dtype=torch.int64, device=terms.device)
    acc.index_add_(0, blk, terms.transpose(0, 1).to(torch.int64))
    return _normalize_rows_plain(acc)


def phase1_eval_plain(S: torch.Tensor) -> torch.Tensor:
    return _normalize_rows_plain(_phase1_terms_plain(S).sum(dim=1, dtype=torch.int64))


def phase2_eval_plain(S: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    return _normalize_rows_plain(_phase2_terms_plain(S, wb).sum(dim=1, dtype=torch.int64))


def phase1_partials_plain(S: torch.Tensor) -> torch.Tensor:
    return _block_sums_plain(_phase1_terms_plain(S))


def phase2_partials_plain(S: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    return _block_sums_plain(_phase2_terms_plain(S, wb))


def _check_stack(S: torch.Tensor, tables: int, wb=None) -> torch.device:
    dev = _check_limbs(S) if wb is None else _check_limbs(S, wb)
    if S.dim() != 3 or S.shape[1] != tables or S.shape[0] < 2 or S.shape[0] % 2:
        raise ValueError(f"phase stack of shape {tuple(S.shape)}")
    if wb is not None and wb.numel() != N_LIMBS:
        raise ValueError(f"wb of shape {tuple(wb.shape)}")
    return dev


@lru_cache(maxsize=None)
def _ticket(device: torch.device, stream: int) -> torch.Tensor:
    """The one-launch eval's counter for one stream of `device`: zero when
    made, and reset to zero by the last block of every launch, so launches
    on one stream take turns and two streams never share one."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def _eval_launch(name: str, S: torch.Tensor, wb=None, total: bool = False):
    """Launch the phase-1 (wb None) or phase-2 eval kernel on a CUDA stack,
    counted under `name`: the (G, 3, 16) canonical per-block sums, or with
    `total` their sum y (3, 16) from the same launch."""
    S = S.contiguous()
    half = S.shape[0] // 2
    grid = _eval_grid(half)
    partials = torch.empty((grid, 3, N_LIMBS), dtype=S.dtype, device=S.device)
    out = torch.empty((3, N_LIMBS), dtype=S.dtype, device=S.device) if total else None
    ticket = (_ticket(S.device, torch.cuda.current_stream(S.device).cuda_stream)
              if total else None)
    _launch(name, S.device, _load().gkr_phase_eval, S.shape[1], _ptr(S),
            None if wb is None else _ptr(wb.contiguous()), _ptr(partials), half,
            grid, None if ticket is None else _ptr(ticket),
            None if out is None else _ptr(out))
    return out if total else partials


def phase1_eval(S: torch.Tensor) -> torch.Tensor:
    """S (n, 4, 16) = [W, HA1, HA2, HM] -> y (3, 16): the round polynomial
    sum (HA1_t + HM_t) * W_t + HA2_t at t = 0, 1, 2."""
    if _check_stack(S, 4).type == "cpu":
        return phase1_eval_plain(S)
    return _eval_launch("phase1_eval", S, total=True)


def phase2_eval(S: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """S (n, 3, 16) = [W, FA, FMwb], wb (16,) = W~(b*) -> y (3, 16): the
    round polynomial sum FA_t * (wb + W_t) + FMwb_t * W_t at t = 0, 1, 2."""
    if _check_stack(S, 3, wb).type == "cpu":
        return phase2_eval_plain(S, wb)
    return _eval_launch("phase2_eval", S, wb, total=True)


def phase1_partials(S: torch.Tensor) -> torch.Tensor:
    """The phase-1 sums of `phase1_eval` left as the grid's (G, 3, 16)
    canonical per-block partials, for `round_tail`."""
    if _check_stack(S, 4).type == "cpu":
        return phase1_partials_plain(S)
    return _eval_launch("phase1_partials", S)


def phase2_partials(S: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """The phase-2 sums of `phase2_eval` as (G, 3, 16) block partials."""
    if _check_stack(S, 3, wb).type == "cpu":
        return phase2_partials_plain(S, wb)
    return _eval_launch("phase2_partials", S, wb)


def eval_attrs(tables: int) -> dict:
    """The eval kernel of phase 1 (tables 4) or phase 2 (3) as it runs on
    this card: entries a tile, threads a block, its dynamic shared memory,
    resident blocks an SM."""
    return _eval_attrs(_load(), tables)


def _eval_attrs(lib, tables: int) -> dict:
    a = (ctypes.c_int * 4)()
    rc = lib.gkr_eval_attrs(tables, ctypes.addressof(a))
    if rc != 0:
        raise RuntimeError(f"gkr_eval_attrs({tables}) failed: cudaError {rc}")
    return dict(zip(("tile", "threads", "smem_bytes", "blocks_per_sm"), a))


# --------------------------------------------------------------- eq table
# Replaces pallas_kernels.pl_eq_table_T (gkr_tpu/jaxeng/pallas_kernels.py:214,
# its kernel _eq_extend_T / _mul_scalar2_kernel :191, :180) and, in the
# per-round engine, the XLA doubling chain limbs.eq_table_device.  One launch
# a table: the k variables cut MSB-first into factor tables of EQ_BITS
# variables (32 entries, one a lane), built once a block in shared memory;
# entry b is the value of its row b >> EQ_BITS (the upper tables' product)
# times the last table's entry b & 31, one product an entry (csrc/kernels.cu
# k_eq_table).  Bound at k = 20: the table written once (67 MB = 20 us)
# against 2^20 products = 1.6e8 IMAD slots = 10 us: bytes bind.  With the
# FP64 product (`fr_mul_f64`) the stores bound the kernel, so each warp
# stages its 2 KB row in shared memory and writes it as four 512-byte
# runs.  z stays on the card (for phase 2 it is b*, the device challenges).

EQ_BITS = 5                  # variables of a factor table (csrc EQ_BITS)
EQ_MAX_K = 32                # variables a table takes at most (csrc EQ_MAX_K)


def eq_table_plain(z: torch.Tensor) -> torch.Tensor:
    one = L.const("MONT_ONE_LIMBS", z.device).reshape(1, N_LIMBS)
    t = one.clone()
    for j in range(z.shape[0] - 1, -1, -1):
        zj = z[j].reshape(1, N_LIMBS)
        t = torch.cat([mont_mul_plain(t, L.sub_mod(one, zj)),
                       mont_mul_plain(t, zj)])
    return t


def eq_table(z: torch.Tensor) -> torch.Tensor:
    """chi table of the point z (k, 16) Montgomery limbs -> (2^k, 16),
    MSB-first (z_0 is the top index bit), as `gkr_tpu_torch.mle.eq_table`;
    k at most EQ_MAX_K."""
    dev = _check_limbs(z)
    if z.dim() != 2 or z.shape[0] > EQ_MAX_K:
        raise ValueError(f"eq_table of a point of shape {tuple(z.shape)}")
    if dev.type == "cpu":
        return eq_table_plain(z)
    k = z.shape[0]
    if k == 0:
        return L.const("MONT_ONE_LIMBS", dev).reshape(1, N_LIMBS).clone()
    z = z.contiguous()
    out = torch.empty((1 << k, N_LIMBS), dtype=z.dtype, device=dev)
    _launch("eq_table", dev, _load().gkr_eq_table, _ptr(z), k, _ptr(out))
    return out


# ------------------------------------------------------------ segment sum
# Replaces pallas_kernels.pl_seg_sum_T (gkr_tpu/jaxeng/pallas_kernels.py:618,
# kernel _make_seg_kernel :579) and the XLA cumsum branch it falls back to
# for hot buckets (fused._seg_sorted_T, gkr_tpu/jaxeng/fused.py:157).  The
# gates arrive sorted by bucket key; bucket b holds gates [hib[b-1], hib[b]).
# One thread a bucket sums up to 32 gates itself; a larger bucket is summed
# by the whole block in 64-bit limbs, so one kernel is exact at any skew
# (2^30 gates in one bucket still fit) and a hot bucket is spread over 256
# threads.  The output is the exact integer sum as 18 clean 16-bit limbs,
# limb-major (T, 18, n) as `normalize` reads it.  Bound at the 2^20 layer's
# phase-1 add plan (T = 2, 2^19 gates): 67 MB of weights + 4 MB of
# boundaries read, 151 MB written = 66 us: bytes bind (no products).  The
# library call for the same sums is `index_add_` of the limbs in int64.

def _carry_limbs(seg: torch.Tensor) -> torch.Tensor:
    """(m, 16) int64 exact limb sums (value < 2^288) -> (18, m) clean
    16-bit limbs of the same integer."""
    out, c = [], torch.zeros_like(seg[:, 0])
    for i in range(N_LIMBS):
        s = seg[:, i] + c
        out.append(s & L.MASK)
        c = s >> 16
    out += [c & L.MASK, c >> 16]
    return torch.stack(out)


def seg_sum_plain(weights, hib: torch.Tensor) -> torch.Tensor:
    hib = hib.to(torch.int64)
    start = torch.cat([hib.new_zeros(1), hib[:-1]])
    out = []
    for w in weights:
        C = torch.zeros((w.shape[0] + 1, N_LIMBS), dtype=torch.int64,
                        device=w.device)
        torch.cumsum(w.to(torch.int64), dim=0, out=C[1:])
        out.append(_carry_limbs(C[hib] - C[start]))
    return torch.stack(out).to(L.LIMB_DTYPE)


def seg_sum(weights, hib: torch.Tensor) -> torch.Tensor:
    """Per-bucket sums of T = 1 or 2 weight tables (G, 16) sorted by bucket
    key, with hib (n,) int32 the running gate count up to each bucket ->
    (T, 18, n) relaxed limbs of the exact sums (each limb < 2^16)."""
    weights = list(weights)
    dev = _check_limbs(*weights)
    G = weights[0].shape[0]
    if not 1 <= len(weights) <= 2 or any(w.shape != (G, N_LIMBS) for w in weights):
        raise ValueError("seg_sum takes one or two (G, 16) tables")
    if hib.dtype != torch.int32 or hib.dim() != 1 or hib.device != dev:
        raise ValueError("hib must be an int32 (n,) tensor beside the weights")
    if dev.type == "cpu":
        return seg_sum_plain(weights, hib)
    weights = [w.contiguous() for w in weights]
    n = hib.numel()
    out = torch.empty((len(weights), SEG_LIMBS, n), dtype=L.LIMB_DTYPE,
                      device=dev)
    if n:
        w1 = weights[-1]
        _launch("seg_sum", dev, _load().gkr_seg_sum, _ptr(hib.contiguous()),
                _ptr(weights[0]), _ptr(w1), _ptr(out), n, len(weights))
    return out


# ---------------------------------------------------------------- normalize
# Replaces pallas_kernels.pl_normalize_T and pl_normalize_mul_T
# (gkr_tpu/jaxeng/pallas_kernels.py:521, :554): one kernel, k_normalize<false>
# and <true>.  A thread an entry: the relaxed limbs' carry chain into 16
# words, a 512-bit Montgomery reduction, then x R^2, or with a scalar s
# x (s R), where s R = s * R^2 / R is taken once a block (the scaled kernel
# runs on the blocks the card holds at once, a thread reducing its next
# entry before its product of this one).  Bound at n = 2^20 with 18 limbs
# in: 75 MB read + 67 MB written = 43 us, against 1.5 products an entry (the
# reduction, half a product's word products, and one product) = 4.2e8 IMAD
# = 25 us, with or without s: bytes bind.

def normalize_plain(t: torch.Tensor, scalar=None) -> torch.Tensor:
    out = _normalize_rows_plain(t.T.to(torch.int64))
    if scalar is not None:
        out = mont_mul_plain(out, scalar.reshape(1, N_LIMBS))
    return out


def normalize(t: torch.Tensor, scalar: torch.Tensor | None = None) -> torch.Tensor:
    """Relaxed limbs t (lin, n), lin <= 32, each in [0, 2^31), value
    < p * 2^256 -> (n, 16) canonical Montgomery t mod p, times `scalar`
    (16,) when given."""
    dev = t.device
    if t.dtype != L.LIMB_DTYPE or t.dim() != 2 or not 1 <= t.shape[0] <= 32:
        raise ValueError(f"relaxed limbs of {t.dtype} {tuple(t.shape)}")
    if scalar is not None and (_check_limbs(scalar) != dev
                               or scalar.numel() != N_LIMBS):
        raise ValueError("the scalar must be one (16,) element beside t")
    if dev.type == "cpu":
        return normalize_plain(t, scalar)
    t = t.contiguous()
    n = t.shape[1]
    out = torch.empty((n, N_LIMBS), dtype=L.LIMB_DTYPE, device=dev)
    if n:
        s = None if scalar is None else _ptr(scalar.contiguous())
        _launch("normalize" if scalar is None else "normalize_mul", dev,
                _load().gkr_normalize, _ptr(t), t.shape[0], s, _ptr(out), n)
    return out


# -------------------------------------------------------------------- MiMC
# Replaces pallas_kernels.pl_mimc_multi (gkr_tpu/jaxeng/pallas_kernels.py
# :813, kernels _make_mimc_kernel :769 and _make_mimc_kernel_block :739) and
# jaxeng/mimc_dev.py: MiMC7-91 multi_hash with key 0, so a challenge never
# leaves the card.  The fused rounds hash inside `round_tail`; `mimc_multi`
# is the same device hash as a launch of its own, for r* (the pipelined
# prover) and the bench's hash-latency probe.
#
# What bounds it: one dependent chain, 91 rounds of x^7 an element, run by
# one thread, so its floor is one thread issuing one IMAD a clock: 1092
# products for three elements x the least SASS IMAD count of a product
# (`probes.probe_sass`).  The Pallas kernel's structure (one chain, a
# throughput-shaped product) carried over to the card ran at ~1450 SM
# clocks a product, held by the CIOS carry chain, and one warp issues the
# wide 32x32->64-bit multiplies far below the card's IMAD rate.  The
# design: the hash's own representation and product (`Fr29`, `fr_mul_lat`
# and `fr_sqr_lat` in fr.cuh: 29-bit limbs, 64-bit columns with no carry
# until the reduction, nothing reduced inside the chain); x^7 in three
# dependent products (x^2, then x^3 and x^4 together, then x^3 x^4), x^2
# and x^4 squares; the key table (k + c_i) mod p in shared memory, filled
# by the block's other threads, so the chain never waits on device memory.
# The plain version is the host's exact-integer hash (`mimc.Mimc7`): as
# plain torch limb arithmetic each of the ~1100 serial products would be
# some hundred tiny launches.

@lru_cache(maxsize=None)
def _mimc_constants(device: torch.device) -> torch.Tensor:
    return L.pack(mimc7_constants(MIMC_ROUNDS), device)


def mimc_multi_plain(x: torch.Tensor) -> torch.Tensor:
    return L.pack_scalar(Mimc7(MIMC_ROUNDS).multi_hash(L.unpack(x), 0),
                         x.device)


def mimc_multi(x: torch.Tensor) -> torch.Tensor:
    """MiMC7-91 multi_hash of the rows of x (len, 16), key 0 -> (16,)."""
    dev = _check_limbs(x)
    if x.dim() != 2 or x.shape[0] < 1:
        raise ValueError(f"mimc_multi of shape {tuple(x.shape)}")
    if dev.type == "cpu":
        return mimc_multi_plain(x)
    x = x.contiguous()
    out = torch.empty((N_LIMBS,), dtype=L.LIMB_DTYPE, device=dev)
    _launch("mimc_multi", dev, _load().gkr_mimc_multi, _ptr(x), x.shape[0],
            _ptr(_mimc_constants(dev)), MIMC_ROUNDS, _ptr(out))
    return out


# -------------------------------------------------------------- round tail
# Replaces pallas_kernels.pl_round_coeffs (gkr_tpu/jaxeng/pallas_kernels.py
# :479, kernel _finalize_kernel :449) and, on the fused round chain,
# pl_mimc_multi (:813): the cross-block sum of the eval kernels' <= 1024
# partials, the degree-2 interpolation and the hash of the round's 2 or 3
# coefficients, in one launch of one block.  The round is then three
# launches: partials, tail, fold.  Tables halve every round, so there is no
# rescale factor.  The sum is lazy (16-bit limbs into 32-bit accumulators,
# warp shuffles, one reduction mod p a value).  Bound: 147 KB read at
# G = 1024 = 0.04 us, against the hash's one-thread chain (see MiMC above),
# which binds.

def round_coeffs_plain(partials: torch.Tensor) -> torch.Tensor:
    y0, y1, y2 = _normalize_rows_plain(partials.sum(dim=0, dtype=torch.int64))
    c2 = mont_mul_plain(L.sub_mod(L.add_mod(y2, y0), L.add_mod(y1, y1)),
                        L.const("INV2_LIMBS", partials.device))
    return torch.stack([c2, L.sub_mod(L.sub_mod(y1, y0), c2), y0])


def round_tail_plain(partials: torch.Tensor, length: int):
    coeffs = round_coeffs_plain(partials)
    return coeffs, mimc_multi_plain(coeffs[3 - length:])


def round_tail(partials: torch.Tensor, length: int):
    """(G, 3, 16) canonical block sums of g(0), g(1), g(2), G <= 1024 ->
    ((3, 16) coefficients (c2, c1, c0) of the degree-2 round polynomial,
    (16,) the round's challenge: MiMC7-91 multi_hash of coeffs[3 - length:],
    key 0), length 2 or 3."""
    dev = _check_limbs(partials)
    if (partials.dim() != 3 or partials.shape[1] != 3
            or not 1 <= partials.shape[0] <= TAIL_MAX_G or length not in (2, 3)):
        raise ValueError(f"round_tail of partials {tuple(partials.shape)}, "
                         f"length {length}")
    if dev.type == "cpu":
        return round_tail_plain(partials, length)
    partials = partials.contiguous()
    coeffs = torch.empty((3, N_LIMBS), dtype=L.LIMB_DTYPE, device=dev)
    r = torch.empty((N_LIMBS,), dtype=L.LIMB_DTYPE, device=dev)
    _launch("round_tail", dev, _load().gkr_round_tail, _ptr(partials),
            partials.shape[0], length, _ptr(_mimc_constants(dev)), MIMC_ROUNDS,
            _ptr(coeffs), _ptr(r))
    return coeffs, r


# -------------------------------------------------------------------- stack
# Replaces pallas_kernels.pl_transpose_T (gkr_tpu/jaxeng/pallas_kernels.py
# :873, kernel _tr_kernel :868), the JAX builds' layout step: there W (n, 16)
# is transposed into the limb-major layout of the (T, 16, n) stack; here W
# and the built tables go into the row-major (n, T, 16) stack the round
# kernels read, the transpose of the (T, n) element axes, in one launch a
# build.  A table given as None is written as zeros (the output layer has no
# mult gates).  Bound for the 2^20 phase-1 stack: 268 MB read + 268 MB
# written = 160 us: bytes bind (no products).  The library call for the same
# layout is `torch.stack(tables, dim=1)`, which is also the plain version.

def stack_plain(tables) -> torch.Tensor:
    ref = next(t for t in tables if t is not None)
    return torch.stack([torch.zeros_like(ref) if t is None else t
                        for t in tables], dim=1)


def stack(tables) -> torch.Tensor:
    """T = 1..4 tables (n, 16), each a tensor or None for zeros ->
    (n, T, 16) with out[s, j] = tables[j][s]."""
    tables = list(tables)
    given = [t for t in tables if t is not None]
    if not 1 <= len(tables) <= 4 or not given:
        raise ValueError("stack takes one to four tables, not all None")
    dev = _check_limbs(*given)
    n = given[0].shape[0]
    if any(t.shape != (n, N_LIMBS) for t in given):
        raise ValueError("stack takes (n, 16) tables of one length")
    if dev.type == "cpu":
        return stack_plain(tables)
    tables = [None if t is None else t.contiguous() for t in tables]
    out = torch.empty((n, len(tables), N_LIMBS), dtype=L.LIMB_DTYPE, device=dev)
    if n:
        srcs = [None if t is None else _ptr(t) for t in tables]
        srcs += [None] * (4 - len(srcs))
        _launch("stack", dev, _load().gkr_stack, *srcs, len(tables), _ptr(out), n)
    return out


# =================================================================== probes
# The port bench's probes (csrc/probes.cu).  They take 32-bit words: int32
# tensors holding u32 (or i32) bit patterns, float32 for the f32 ops.  On
# the CPU this torch refuses uint32 arithmetic, so the plain versions compute
# in int64 and keep the low 32 bits.

U32 = 0xFFFFFFFF
CHAINS = 8                       # independent accumulators of u32_mul_chain
CHAIN_REPS = (16, 128)           # the peak probe's two depths (bench.py)
MICRO_OPS = ("u32_add", "u32_mul", "u32_mul16", "u32_shift", "i32_mul",
             "f32_mul", "f32_fma")
MICRO_REPS = (16, 1040, 4112)     # scripts/micro_vpu.py's REPS; two deep runs
MONT_VARIANTS = ("cios32", "school", "lat", "f64", "cc")
MONT_FP64 = ("f64",)             # variants whose products run on the FP64 pipe
MONT_DEPTHS = (1, 9)             # scripts/tune_pallas_mul.py's lo and hi depth
MONT_BLOCKS = (128, 256, 512, 1024)


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    return t.to(torch.int64) & U32


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 tensor of the same bits."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _mul32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x * y mod 2^32 of int64 values in [0, 2^32), without an int64
    overflow: the high halves' cross products only reach bits 16..31."""
    xl, yl = x & 0xFFFF, y & 0xFFFF
    cross = ((x >> 16) * yl + xl * (y >> 16)) & 0xFFFF
    return (xl * yl + (cross << 16)) & U32


def _check_words(a: torch.Tensor, b: torch.Tensor, dtype=torch.int32) -> torch.device:
    if a.dtype != dtype or b.dtype != dtype or a.shape != b.shape:
        raise ValueError(f"expected two {dtype} tensors of one shape, got "
                         f"{a.dtype} {tuple(a.shape)} and {b.dtype} {tuple(b.shape)}")
    if a.device != b.device or a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tensors on {a.device} and {b.device}")
    return a.device


# ------------------------------------------------------------ u32 peak probe
# Replaces bench.py `_measure_vpu_peak` (:133, pallas_call :164).  Each
# element runs 8 independent accumulators acc_c = a + c, then `reps`
# products acc_c *= b, and writes their sum, all mod 2^32.  Bound at
# (16, 2^20) words: 201 MB moved = 60 us, against 2^24 * 8 * reps IMAD at
# 132 SMs x 64 a clock x 1.98 GHz = 16.7 T/s: 0.13 ms at reps = 16, 1.03 ms
# at 128: operations bind.  Its marginal rate between the two depths is the
# card's measured IMAD rate, the bench's compute anchor.  The products are
# inline PTX so that the compiler cannot fold the chain (see probes.cu).

def u32_mul_chain_plain(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    x, y = _u32(a), _u32(b)
    accs = [(x + c) & U32 for c in range(CHAINS)]
    for _ in range(reps):
        accs = [_mul32(acc, y) for acc in accs]
    return _as_i32(sum(accs) & U32)


def u32_mul_chain(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """sum over c < 8 of (a + c) * b^reps mod 2^32, elementwise, of u32
    words held in int32 tensors; reps is 16 or 128."""
    dev = _check_words(a, b)
    if reps not in CHAIN_REPS:
        raise ValueError(f"u32_mul_chain reps {reps} not in {CHAIN_REPS}")
    if dev.type == "cpu":
        return u32_mul_chain_plain(a, b, reps)
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    if a.numel():
        _launch("u32_mul_chain", dev, _load().gkr_u32_mul_chain,
                _ptr(a), _ptr(b), _ptr(out), a.numel(), reps)
    return out


# ------------------------------------------------------------ per-op probe
# Replaces scripts/micro_vpu.py `make_bench` (:38, pallas_call :65): acc =
# a, then REPS times acc = op(acc, b), elementwise.  One kernel template,
# one instantiation an op and depth.  Bound at (16, 2^20) words and
# REPS = 16: 201 MB = 60 us against 2^28 ops (at most 3 instructions each,
# 64 int32 or 128 fp32 a clock per SM: <= 48 us): bytes bind; at 1040 and
# 4112 repetitions the instructions bind, so the marginal time between
# those two is the op's cost (between 16 and a deep run it is not: at 16
# the memory traffic hides the instructions; between 272 and 1040 the
# memory the shallower run leaves unhidden still read up to 1.9% above
# the card's peak).  The integer ops are inline PTX (no
# folding), f32_mul a rounded multiply (never contracted into an FMA),
# f32_fma one `fmaf`.  The plain f32_fma rounds twice a step (multiply,
# then add), the kernel once, so f32 results are compared with a relative
# tolerance.

def micro_op_plain(op: str, a: torch.Tensor, b: torch.Tensor,
                   reps: int = 16) -> torch.Tensor:
    if op.startswith("f32"):
        acc = a
        for _ in range(reps):
            acc = acc * b if op == "f32_mul" else acc * b + a
        return acc
    acc, y = _u32(a), _u32(b)
    for _ in range(reps):
        if op == "u32_add":
            acc = (acc + y) & U32
        elif op in ("u32_mul", "i32_mul"):     # the same low 32 bits
            acc = _mul32(acc, y)
        elif op == "u32_mul16":
            acc = (acc & 0xFFFF) * (y & 0xFFFF)
        else:                                   # u32_shift
            acc = ((acc >> 16) + y) & U32
    return _as_i32(acc)


def micro_op(op: str, a: torch.Tensor, b: torch.Tensor, reps: int = 16) -> torch.Tensor:
    """`reps` times acc = op(acc, b) from acc = a, elementwise: u32 and i32
    words in int32 tensors, f32 in float32 ones; reps is 16, 1040 or 4112."""
    if op not in MICRO_OPS or reps not in MICRO_REPS:
        raise ValueError(f"micro_op {op!r} x {reps}: ops {MICRO_OPS}, reps {MICRO_REPS}")
    dev = _check_words(a, b, torch.float32 if op.startswith("f32") else torch.int32)
    if dev.type == "cpu":
        return micro_op_plain(op, a, b, reps)
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    if a.numel():
        _launch("micro_op", dev, _load().gkr_micro_op, _ptr(a), _ptr(b),
                _ptr(out), a.numel(), MICRO_OPS.index(op), reps)
    return out


# -------------------------------------------------------- Montgomery chain
# Replaces scripts/tune_pallas_mul.py `build` (:92, pallas_call :97) with
# the kernels of `make_kernel` (:78): x = x * b / R, `depth` times, per
# element.  Five variants of the port's own product, chosen for this card
# (fr.cuh): "cios32", `fr_mul_cios32`, 8 x 32-bit CIOS with 64-bit carry
# sums; "school", the full 8 x 8 word product and then `fr_redc_wide`;
# "lat", `fr_mul_lat`, the hash's product on 29-bit limbs (x and b
# converted once, the chain in that form, x converted back); "f64",
# `fr_mul_f64`, the product on the FP64 pipe (52-bit limbs as doubles,
# exact FMA splits, 64-bit integer columns; b converted once), which the
# throughput kernels take as `fr_mul`; "cc", CIOS with its carries in PTX
# multiply-add chains.  Block widths 128 to 1024 threads are
# template instantiations (`__launch_bounds__` sets the register budget as
# a Pallas block width would).  Bound at 2^20 elements: 201 MB = 60 us,
# against depth * 2^20 * 151.625 IMAD slots at 16.7 T/s = depth * 9.5 us:
# bytes bind at depth 1, operations at depth 9 (the f64 variant at its own
# floor, 196.5 slots a product).  The probe's marginal time between
# depths 1 and 9 is the product's cost without the memory traffic; at one
# element (one thread) it is the latency of a dependent product.

def mont_chain_plain(a: torch.Tensor, b: torch.Tensor, depth: int) -> torch.Tensor:
    x = a
    for _ in range(depth):
        x = mont_mul_plain(x, b)
    return x


def mont_chain(a: torch.Tensor, b: torch.Tensor, depth: int,
               variant: str = "cios32", block: int = THREADS) -> torch.Tensor:
    """x = a, then `depth` times x = x * b / R mod p, elementwise over
    (n, 16) canonical limbs; depth 1 or 9, variant one of MONT_VARIANTS,
    block 128 to 1024 threads."""
    dev = _check_limbs(a, b)
    if (a.shape != b.shape or variant not in MONT_VARIANTS
            or depth not in MONT_DEPTHS or block not in MONT_BLOCKS):
        raise ValueError(f"mont_chain {variant} depth {depth} block {block} of "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if dev.type == "cpu":
        return mont_chain_plain(a, b, depth)
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    n = a.numel() // N_LIMBS
    if n:
        _launch(f"mont_chain_{variant}", dev, _load().gkr_mont_chain,
                _ptr(a), _ptr(b), _ptr(out), n, MONT_VARIANTS.index(variant),
                depth, block)
    return out
