"""Exact BN254 Fr arithmetic on torch tensors: 16 limbs x 16 bits.

The port's counterpart of the JAX package's `jaxeng/limbs.py`, with the
same representation, so limb arrays carry over bit for bit:

  * a field element is a trailing axis of 16 limbs of 16 bits, least
    significant first, in Montgomery form (x * R mod p, R = 2^256); the
    tensors are int32 (this torch refuses `+`, `>>` and comparisons on
    uint32 on the CPU, and int32 holds a 16-bit limb exactly);
  * additive accumulations (wiring scatters, block sums) use RELAXED limbs
    in int64, renormalized by one wide REDC and a multiply by R^2;
  * every Montgomery product goes through `kernels.mont_mul`: the CUDA
    kernel for a tensor on the card, its plain version for one on the CPU.
    The carry chains, `redc` and the modular adds stay plain torch, as the
    JAX package leaves them to XLA.

Leading axes are batch axes; functions take and return canonical limbs
(< p) unless they say otherwise.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import tracing
from ..field import N_LIMBS, NPRIME16, P, R, R2

MASK = 0xFFFF
WIDE = 2 * N_LIMBS
LIMB_DTYPE = torch.int32


def _int_to_limbs(x: int, n: int = N_LIMBS) -> list[int]:
    return [(x >> (16 * i)) & MASK for i in range(n)]


P_LIMBS = _int_to_limbs(P)
NEG_P_LIMBS = _int_to_limbs((1 << 256) - P)
R2_LIMBS = _int_to_limbs(R2)
MONT_ONE_LIMBS = _int_to_limbs(R % P)          # 1 in Montgomery form
INV2_LIMBS = _int_to_limbs(pow(2, P - 2, P) * R % P)   # 1/2, Montgomery


def upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on `device`.  To a card the copy goes
    through pinned memory, asynchronously on the current stream, so it never
    waits for the work queued before it (a pageable copy synchronises)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


@lru_cache(maxsize=None)
def _const(name: str, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A (16,) constant limb row on `device` (cached: one upload each)."""
    np_dtype = np.int64 if dtype == torch.int64 else np.int32
    return upload(np.array(globals()[name], dtype=np_dtype), device)


def const(name: str, device, dtype=LIMB_DTYPE) -> torch.Tensor:
    return _const(name, torch.device(device), dtype)


# --------------------------------------------------------------- host codec

PACK_DEVICE_MIN = 1 << 12    # below this the host does the *R % P directly


def canonical_limbs(values) -> np.ndarray:
    """Python ints -> (n, 16) int32 limbs of the canonical values (not
    Montgomery): one bytes join on the host."""
    n = len(values)
    b = b"".join((int(v) % P).to_bytes(32, "little") for v in values)
    return np.frombuffer(b, dtype=np.uint16).astype(np.int32).reshape(n, N_LIMBS)


def pack(values, device="cpu") -> torch.Tensor:
    """Python ints -> (n, 16) int32 Montgomery limb tensor on `device`.

    Large tables skip the host-side Montgomery conversion (a Python bigint
    modmul per element) and multiply by R^2 on the device instead:
    v * R2 / R = v * R mod p, bit-identical.  The host's conversion of the
    ints runs under the `limbs.to_limbs` span."""
    if len(values) >= PACK_DEVICE_MIN:
        with tracing.span("limbs.to_limbs"):
            host = canonical_limbs(values)
        raw = upload(host, device)
        return mont_mul(raw, const("R2_LIMBS", raw.device))
    with tracing.span("limbs.to_limbs"):
        host = canonical_limbs([int(v) % P * R % P for v in values])
    return upload(host, device)


def pack_scalar(v: int, device="cpu") -> torch.Tensor:
    return pack([v], device)[0]


def unpack(t: torch.Tensor, montgomery: bool = True) -> list[int]:
    """(..., 16) limbs -> list of canonical Python ints (leading axes
    flattened row-major).  The host's conversion, after the copy to the
    host, runs under the `limbs.from_limbs` span."""
    a = t.detach().reshape(-1, N_LIMBS).to("cpu", torch.int32).numpy()
    with tracing.span("limbs.from_limbs"):
        raw = a.astype(np.uint16).tobytes()
        rinv = pow(R, P - 2, P)
        out = []
        for i in range(a.shape[0]):
            v = int.from_bytes(raw[32 * i:32 * i + 32], "little")
            if montgomery:
                v = v * rinv % P
            out.append(v % P)
    return out


def unpack_scalar(t: torch.Tensor) -> int:
    return unpack(t.reshape(1, N_LIMBS))[0]


# ------------------------------------------------------------- carry chains

def carry_canonical(t: torch.Tensor, with_overflow: bool = False):
    """Propagate carries over 16 relaxed limbs -> clean 16-bit limbs
    (mod 2^256).  With `with_overflow`, also return the carry out of limb
    15 (the value div 2^256)."""
    assert t.shape[-1] == N_LIMBS
    carry = torch.zeros_like(t[..., 0])
    out = []
    for i in range(N_LIMBS):
        s = t[..., i] + carry
        out.append(s & MASK)
        carry = s >> 16
    res = torch.stack(out, dim=-1)
    if with_overflow:
        return res, carry
    return res


def cond_sub_p(t: torch.Tensor) -> torch.Tensor:
    """If t >= p, subtract p (t clean, < 2p): complement-add + overflow."""
    s, overflow = carry_canonical(t + const("NEG_P_LIMBS", t.device, t.dtype),
                                  with_overflow=True)
    return torch.where((overflow > 0).unsqueeze(-1), s, t)


# ------------------------------------------------------------ modular + / -

def add_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return cond_sub_p(carry_canonical(a + b))


def sub_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod p via complement: a + p + (2^256-b), dropping the 2^256."""
    u = a + const("P_LIMBS", a.device, a.dtype) + (MASK - b)
    u[..., 0] += 1
    return cond_sub_p(carry_canonical(u))


# -------------------------------------------------------- Montgomery multiply

def conv_columns(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product of two 16-limb values as 32 relaxed int64 columns
    (each a sum of at most 16 products below 2^32: < 2^36).  Forms the
    (..., 16, 16) partial products: CPU-sized batches only (2 GiB at 2^20
    rows)."""
    p = a.to(torch.int64).unsqueeze(-1) * b.to(torch.int64).unsqueeze(-2)
    cols = torch.zeros(p.shape[:-2] + (WIDE,), dtype=torch.int64,
                       device=p.device)
    for i in range(N_LIMBS):
        cols[..., i:i + N_LIMBS] += p[..., i, :]
    return cols


def redc(t: torch.Tensor) -> torch.Tensor:
    """Montgomery reduction of (..., <=32) relaxed int64 limbs -> canonical
    16 int32 limbs of t / R mod p.

    Contract: value < p * 2^256 and every limb < 2^40 (int64 keeps every
    intermediate exact: 16 steps add at most 16 products below 2^32 and the
    carries to a limb, so every limb stays below 2^41).  Limb i is consumed
    at step i: m*p, added at limbs i..i+15, cancels its low 16 bits, and its
    high part is carried into limb i+1."""
    src = t
    t = torch.zeros(src.shape[:-1] + (WIDE,), dtype=torch.int64,
                    device=src.device)
    t[..., :src.shape[-1]] = src
    p_limbs = const("P_LIMBS", t.device, torch.int64)
    for i in range(N_LIMBS):
        m = ((t[..., i] & MASK) * NPRIME16) & MASK
        t[..., i:i + N_LIMBS] += m.unsqueeze(-1) * p_limbs   # products < 2^32
        t[..., i + 1] += t[..., i] >> 16                     # low 16 bits are 0
    return cond_sub_p(carry_canonical(t[..., N_LIMBS:])).to(LIMB_DTYPE)


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(aR)(bR) -> abR mod p; see `kernels.mont_mul` for how b broadcasts."""
    from .kernels import mont_mul as _mont_mul
    return _mont_mul(a, b)


def mul_scalar(table: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Multiply every row of (..., 16) by a single (16,) scalar."""
    return mont_mul(table, s.reshape(1, N_LIMBS))


def normalize_relaxed(t: torch.Tensor) -> torch.Tensor:
    """Relaxed limb accumulations (<= 32 limbs, value < p * 2^256, see
    `redc`) -> canonical Montgomery form: REDC(t) = t/R, then * R^2 / R."""
    return mul_scalar(redc(t), const("R2_LIMBS", t.device))


def sum_mod(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading axis of (n, ..., 16) -> (..., 16), exact mod p:
    one int64 limb sum (each < n * 2^16) and one renormalization."""
    if x.shape[0] == 0:
        return torch.zeros(x.shape[1:], dtype=LIMB_DTYPE, device=x.device)
    return normalize_relaxed(x.sum(dim=0, dtype=torch.int64))


# ------------------------------------------------------------------- helpers

def eval3_halves(t: torch.Tensor):
    """Return (lo, hi, 2*hi - lo): the table evaluated at x_1 = 0, 1, 2."""
    half = t.shape[0] // 2
    lo, hi = t[:half], t[half:]
    return lo, hi, add_mod(hi, sub_mod(hi, lo))
