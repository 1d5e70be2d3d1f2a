"""The per-round layer sumcheck's four CUDA kernels, with their plain versions.

Each wrapper takes int32 limb tensors (see `limbs`).  For a tensor on the
CPU it runs the plain PyTorch version beside it; for a CUDA tensor it
launches the kernel from `csrc/kernels.cu` or raises -- there is no
fallback.  Each launch adds one to `LAUNCHES[name]`.

The kernels are compiled from the sources in the checkout at first use
(`nvcc` for sm_90a into a plain-C shared library, loaded with ctypes), into
`_build/` beside this package, keyed by a hash of the sources.  Importing
this module needs neither `nvcc` nor a card.

Bounds below are for one H100 SXM (3.35 TB/s; 132 SMs x 64 32-bit IMAD per
clock) at the per-round engine's shapes, n = 2^20 entries, 64 B an element.
A Montgomery product costs 264 32-bit IMADs in the kernels' 8 x 32-bit CIOS
(128 32x32->64-bit products at two IMADs each, plus 8 low products).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from . import limbs as L

N_LIMBS = 16
THREADS = 256
MAX_EVAL_BLOCKS = 1024       # partial sums per eval launch (second pass: sum_mod)

LAUNCHES = {"mont_mul": 0, "fold": 0, "phase1_eval": 0, "phase2_eval": 0}

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("fr.cuh", "kernels.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
BUILD_LOG = ""


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
    for name in SOURCES:
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
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / "kernels.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG = res.stdout + res.stderr
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{BUILD_LOG}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        signatures = {
            "gkr_mont_mul": [vp, vp, vp, ll, ll, vp],
            "gkr_fold": [vp, vp, vp, ll, vp],
            "gkr_phase1_partials": [vp, vp, ll, i, vp],
            "gkr_phase2_partials": [vp, vp, vp, ll, i, vp],
        }
        for name, args in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


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


def _sum_mod_plain(x: torch.Tensor) -> torch.Tensor:
    return mont_mul_plain(L.redc(x.sum(dim=0, dtype=torch.int64)),
                          L.const("R2_LIMBS", x.device))


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
# Replace pallas_kernels.pl_phase1_eval / pl_phase2_eval
# (gkr_tpu/jaxeng/pallas_kernels.py:318, :368).  Blocks run in no order, so
# the sum runs in two passes: each block of 256 threads walks the half-table
# with a grid stride, adds canonically in registers, folds its threads by a
# tree of field adds in shared memory and writes one canonical (3, 16)
# partial; `limbs.sum_mod` adds the <= 1024 partials, as the JAX package's
# XLA reduce does.  Bounds at n = 2^20: phase 1 reads 268 MB = 80 us, against
# 3 * 2^19 products = 4.2e8 IMAD = 25 us; phase 2 reads 201 MB = 60 us,
# against 6 * 2^19 products = 8.3e8 IMAD = 50 us.  Both bind on bytes.

def _eval_grid(half: int) -> int:
    return max(1, min(MAX_EVAL_BLOCKS, -(-half // THREADS)))


def phase1_eval_plain(S: torch.Tensor) -> torch.Tensor:
    lo, hi, at2 = L.eval3_halves(S)
    out = []
    for X in (lo, hi, at2):
        w, ha1, ha2, hm = X[:, 0], X[:, 1], X[:, 2], X[:, 3]
        out.append(_sum_mod_plain(
            L.add_mod(mont_mul_plain(L.add_mod(ha1, hm), w), ha2)))
    return torch.stack(out)


def phase1_partials(S: torch.Tensor) -> torch.Tensor:
    """The phase-1 kernel alone, on a CUDA stack: (G, 3, 16) canonical
    per-block sums."""
    S = S.contiguous()
    half = S.shape[0] // 2
    grid = _eval_grid(half)
    partials = torch.empty((grid, 3, N_LIMBS), dtype=S.dtype, device=S.device)
    _launch("phase1_eval", S.device, _load().gkr_phase1_partials, _ptr(S),
            _ptr(partials), half, grid)
    return partials


def phase1_eval(S: torch.Tensor) -> torch.Tensor:
    """S (n, 4, 16) = [W, HA1, HA2, HM] -> y (3, 16): the round polynomial
    sum (HA1_t + HM_t) * W_t + HA2_t at t = 0, 1, 2."""
    dev = _check_limbs(S)
    if S.dim() != 3 or S.shape[1] != 4 or S.shape[0] % 2:
        raise ValueError(f"phase-1 stack of shape {tuple(S.shape)}")
    if dev.type == "cpu":
        return phase1_eval_plain(S)
    return L.sum_mod(phase1_partials(S))


def phase2_eval_plain(S: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    lo, hi, at2 = L.eval3_halves(S)
    out = []
    for X in (lo, hi, at2):
        w, fa, fmwb = X[:, 0], X[:, 1], X[:, 2]
        out.append(_sum_mod_plain(L.add_mod(
            mont_mul_plain(fa, L.add_mod(wb, w)), mont_mul_plain(fmwb, w))))
    return torch.stack(out)


def phase2_partials(S: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """The phase-2 kernel alone, on CUDA tensors: (G, 3, 16) canonical
    per-block sums."""
    S, wb = S.contiguous(), wb.contiguous()
    half = S.shape[0] // 2
    grid = _eval_grid(half)
    partials = torch.empty((grid, 3, N_LIMBS), dtype=S.dtype, device=S.device)
    _launch("phase2_eval", S.device, _load().gkr_phase2_partials, _ptr(S), _ptr(wb),
            _ptr(partials), half, grid)
    return partials


def phase2_eval(S: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """S (n, 3, 16) = [W, FA, FMwb], wb (16,) = W~(b*) -> y (3, 16): the
    round polynomial sum FA_t * (wb + W_t) + FMwb_t * W_t at t = 0, 1, 2."""
    dev = _check_limbs(S, wb)
    if S.dim() != 3 or S.shape[1] != 3 or S.shape[0] % 2 or wb.numel() != N_LIMBS:
        raise ValueError(f"phase-2 stack of shape {tuple(S.shape)}")
    if dev.type == "cpu":
        return phase2_eval_plain(S, wb)
    return L.sum_mod(phase2_partials(S, wb))
