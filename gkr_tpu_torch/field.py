"""BN254 scalar field (Fr) host arithmetic.

The reference uses `halo2curves::bn256::Fr` (rust/Cargo.toml:21-22) and
`ethsnarks.field.FQ` (python/poly.py:1) — both the alt_bn128 / BN128 snark
scalar field.  On the host we use Python's arbitrary-precision integers, which
are exact; the CUDA engine in `gkr_tpu_torch.torcheng.limbs` carries the same
values as 16x16-bit limb tensors in Montgomery form.

All host protocol code represents field elements as plain `int` in [0, P).
"""

from __future__ import annotations

# BN254 (alt_bn128) scalar field modulus.
P = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# Montgomery parameters for the 16x16-bit-limb device representation
# (radix 2^16, R = 2^256).
LIMB_BITS = 16
N_LIMBS = 16
R = (1 << 256) % P
R2 = (R * R) % P
R3 = (R * R2) % P
# -P^{-1} mod 2^16 (per-limb Montgomery factor).
NPRIME16 = (-pow(P, -1, 1 << 16)) % (1 << 16)
# -P^{-1} mod 2^32 (for 32-bit-limb variants).
NPRIME32 = (-pow(P, -1, 1 << 32)) % (1 << 32)

ZERO = 0
ONE = 1
TWO = 2


def fadd(a: int, b: int) -> int:
    return (a + b) % P


def fsub(a: int, b: int) -> int:
    return (a - b) % P


def fmul(a: int, b: int) -> int:
    return (a * b) % P


def fneg(a: int) -> int:
    return (-a) % P


def finv(a: int) -> int:
    if a % P == 0:
        raise ZeroDivisionError("inverse of zero in Fr")
    return pow(a, P - 2, P)


def fpow(a: int, e: int) -> int:
    return pow(a, e, P)


def to_repr(a: int) -> bytes:
    """32-byte little-endian canonical representation (ff::PrimeField Repr =
    [u8; 32] convention, rust/src/gkr/sumcheck.rs:10-22)."""
    return int(a % P).to_bytes(32, "little")


def from_repr(b: bytes) -> int:
    v = int.from_bytes(b, "little")
    if v >= P:
        raise ValueError("non-canonical field repr")
    return v


def to_decimal_str(a: int) -> str:
    """Decimal string as emitted for circom inputs (rust/src/file_utils.rs:20-28)."""
    return str(a % P)


def batch_inv(xs: list[int]) -> list[int]:
    """Montgomery batch inversion: one `finv` for the whole list."""
    n = len(xs)
    out = [0] * n
    acc = 1
    prefix = [0] * n
    for i, x in enumerate(xs):
        if x % P == 0:
            raise ZeroDivisionError("inverse of zero in Fr")
        prefix[i] = acc
        acc = acc * x % P
    inv = finv(acc)
    for i in range(n - 1, -1, -1):
        out[i] = inv * prefix[i] % P
        inv = inv * xs[i] % P
    return out


def eval_univariate(coeffs: list[int], x: int) -> int:
    """Horner evaluation; `coeffs[0]` is the HIGHEST-degree coefficient.

    This coefficient order is used everywhere in the reference
    (rust/src/gkr/poly.rs:260-267, python/poly.py:248-253,
    circom poly/univariate.circom:10-14).
    """
    if not coeffs:
        return 0
    res = coeffs[0] % P
    for c in coeffs[1:]:
        res = (res * x + c) % P
    return res


def add_univariate(p: list[int], q: list[int]) -> list[int]:
    """Add two dense univariates in highest-degree-first order
    (rust/src/gkr/poly.rs:444-467 semantics, including empty-operand cases)."""
    if not p:
        return list(q)
    if not q:
        return list(p)
    n = max(len(p), len(q))
    pr, qr = p[::-1], q[::-1]
    out = []
    for i in range(n):
        a = pr[i] if i < len(pr) else 0
        b = qr[i] if i < len(qr) else 0
        out.append((a + b) % P)
    return out[::-1]


def mult_univariate(p: list[int], q: list[int]) -> list[int]:
    """Multiply two dense univariates (highest-degree-first).  The output
    length is structural: len(p)+len(q)-1, regardless of leading zeros —
    matching rust/src/gkr/poly.rs:422-442 (this matters for transcript
    shape parity)."""
    n = len(p) + len(q) - 1
    out = [0] * n
    pr, qr = p[::-1], q[::-1]
    for i, a in enumerate(pr):
        for j, b in enumerate(qr):
            out[i + j] = (out[i + j] + a * b) % P
    return out[::-1]


def interpolate(points: list[tuple[int, int]]) -> list[int]:
    """Exact Lagrange interpolation.  Returns coefficients highest-degree-first
    with structural length == len(points).

    Used to recover q_i(t) = W~(l(t)) coefficients from point evaluations
    instead of the reference's symbolic term-product construction
    (rust/src/gkr/poly.rs:469-500); the polynomial is identical, hence the
    coefficients are identical.
    """
    n = len(points)
    # coeffs lowest-first during accumulation
    acc = [0] * n
    denoms = []
    for i, (xi, _) in enumerate(points):
        d = 1
        for j, (xj, _) in enumerate(points):
            if i != j:
                d = d * (xi - xj) % P
        denoms.append(d)
    inv_denoms = batch_inv(denoms)
    for i, (xi, yi) in enumerate(points):
        # numerator poly prod_{j!=i} (x - xj), lowest-first
        num = [1]
        for j, (xj, _) in enumerate(points):
            if i == j:
                continue
            new = [0] * (len(num) + 1)
            for d, c in enumerate(num):
                new[d] = (new[d] - c * xj) % P
                new[d + 1] = (new[d + 1] + c) % P
            num = new
        scale = yi * inv_denoms[i] % P
        for d in range(len(num)):
            acc[d] = (acc[d] + num[d] * scale) % P
    return acc[::-1]
