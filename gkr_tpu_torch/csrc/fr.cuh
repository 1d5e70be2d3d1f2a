// BN254 scalar field (Fr) arithmetic on the device, Montgomery form with
// R = 2^256, the same representation as gkr_tpu_torch.torcheng.limbs.
//
// Storage (what the kernels read and write): one element is 16 uint32 slots,
// each holding a 16-bit limb, least significant first -- 64 bytes, the
// layout of the port's int32 limb tensors.  Inside a thread an element is
// repacked into 8 32-bit words and multiplied by CIOS (coarsely integrated
// operand scanning) Montgomery multiplication with a 32-bit radix.  R is
// 2^256 for both limb widths, so results are the same canonical values as
// the 16-bit reference; the 32-bit factor is -p^-1 mod 2^32 (FR_NPRIME32),
// not the 16-bit one.
//
// Every Fr a function here takes or returns is canonical (< p).  The hash
// runs on its own representation, Fr29, at the end of this file.
#pragma once

#include <stdint.h>

// p = 21888242871839275222246405745257275088548364400416034343698204186575808495617,
// 32-bit words, least significant first.
static __constant__ uint32_t FR_P[8] = {
    0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
    0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};

// -p^-1 mod 2^32
#define FR_NPRIME32 0xefffffffu

// 1 in Montgomery form: R mod p.
static __constant__ uint32_t FR_ONE[8] = {
    0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u,
    0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};

// R^2 mod p: fr_mul(x, R^2) = x * R mod p.
static __constant__ uint32_t FR_R2[8] = {
    0xae216da7u, 0x1bb8e645u, 0xe35c59e3u, 0x53fe3ab1u,
    0x53bb8085u, 0x8c49833du, 0x7f4e44a5u, 0x0216d0b1u};

struct Fr {
  uint32_t w[8];
};

// 16 16-bit limbs held in uint32 slots (64 bytes, 16-byte aligned) -> 8 words.
__device__ __forceinline__ Fr fr_load(const uint32_t* src) {
  const uint4* q = reinterpret_cast<const uint4*>(src);
  Fr r;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint4 v = q[k];
    r.w[2 * k] = (v.x & 0xffffu) | (v.y << 16);
    r.w[2 * k + 1] = (v.z & 0xffffu) | (v.w << 16);
  }
  return r;
}

__device__ __forceinline__ void fr_store(uint32_t* dst, const Fr& a) {
  uint4* q = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    q[k] = make_uint4(a.w[2 * k] & 0xffffu, a.w[2 * k] >> 16,
                      a.w[2 * k + 1] & 0xffffu, a.w[2 * k + 1] >> 16);
  }
}

__device__ __forceinline__ Fr fr_zero() {
  Fr r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = 0u;
  return r;
}

// t < 2p -> t mod p
__device__ __forceinline__ Fr fr_reduce_once(const Fr& t) {
  Fr d;
  uint32_t borrow = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t s = (uint64_t)t.w[j] - FR_P[j] - borrow;
    d.w[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  return borrow ? t : d;
}

// a + b mod p.  p < 2^254, so a + b < 2^255 has no carry out of word 7.
__device__ __forceinline__ Fr fr_add(const Fr& a, const Fr& b) {
  Fr s;
  uint32_t carry = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t v = (uint64_t)a.w[j] + b.w[j] + carry;
    s.w[j] = (uint32_t)v;
    carry = (uint32_t)(v >> 32);
  }
  return fr_reduce_once(s);
}

// a - b mod p
__device__ __forceinline__ Fr fr_sub(const Fr& a, const Fr& b) {
  Fr d;
  uint32_t borrow = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t v = (uint64_t)a.w[j] - b.w[j] - borrow;
    d.w[j] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  if (borrow) {
    uint32_t carry = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t v = (uint64_t)d.w[j] + FR_P[j] + carry;
      d.w[j] = (uint32_t)v;
      carry = (uint32_t)(v >> 32);
    }
  }
  return d;
}

// Montgomery product a * b / 2^256 mod p (CIOS, 8 x 32-bit words).
// Per product: 64 + 64 32x32->64-bit multiply-adds and 8 low multiplies.
// Each 64-bit sum t + x*y + c is at most 2^64 - 1, so no sum overflows.
__device__ __forceinline__ Fr fr_mul(const Fr& a, const Fr& b) {
  uint32_t t[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) t[j] = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t s = (uint64_t)t[j] + (uint64_t)a.w[j] * b.w[i] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);

    uint32_t m = t[0] * FR_NPRIME32;
    s = (uint64_t)t[0] + (uint64_t)m * FR_P[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      s = (uint64_t)t[j] + (uint64_t)m * FR_P[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[8] + c;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  // a, b < p  =>  the result (a*b + M*p) / 2^256 < 2p < 2^256: t[8] == 0.
  Fr r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = t[j];
  return fr_reduce_once(r);
}

__device__ __forceinline__ Fr fr_const(const uint32_t* c) {
  Fr r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = c[j];
  return r;
}

// a / 2 mod p: a + p when a is odd (a + p < 2^255, no carry out), then >> 1.
__device__ __forceinline__ Fr fr_half(const Fr& a) {
  Fr s = a;
  if (a.w[0] & 1u) {
    uint32_t carry = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t v = (uint64_t)a.w[j] + FR_P[j] + carry;
      s.w[j] = (uint32_t)v;
      carry = (uint32_t)(v >> 32);
    }
  }
#pragma unroll
  for (int j = 0; j < 7; ++j) s.w[j] = (s.w[j] >> 1) | (s.w[j + 1] << 31);
  s.w[7] >>= 1;
  return s;
}

// Montgomery reduction of a wide value T (17 words, value < p * 2^256) ->
// T / 2^256 mod p, canonical.  Word i is cancelled at step i by m * p and
// the carry runs to the top; the result (T + M p) / 2^256 < 2p.
__device__ __forceinline__ Fr fr_redc_wide(uint32_t T[17]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t m = T[i] * FR_NPRIME32;
    uint64_t c = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t s = (uint64_t)T[i + j] + (uint64_t)m * FR_P[j] + c;
      T[i + j] = (uint32_t)s;
      c = s >> 32;
    }
#pragma unroll
    for (int j = i + 8; j < 17; ++j) {
      uint64_t s = (uint64_t)T[j] + c;
      T[j] = (uint32_t)s;
      c = s >> 32;
    }
  }
  Fr r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = T[8 + j];
  return fr_reduce_once(r);
}

// ------------------------------------------------------------------ Fr29
// The hash's representation and its latency-first Montgomery product.
//
// One thread runs the MiMC chain, so a product's cost is one warp's issue
// of its instructions, and on an H100 one warp issues a 32x32->64-bit
// IMAD.WIDE several times slower than a 32-bit IMAD or an IADD3: a product
// is bound by its wide multiplies and by the carries around them.  fr_mul
// spends 583 instructions (120 IMAD.WIDE) and ~1300 SM clocks a dependent
// product (`probes tune`), most of it on 64-bit carry chains.  Here an
// element is 9 limbs of 29 bits
// in 32-bit words (Fr29), and a product sums its 81 limb products (45 for
// a square) into 17 64-bit columns, one IMAD.WIDE each: with limbs below
// 2^30 a column stays below 9 * 2^60 + 9 * 2^58 + 2^35 < 2^64 (a square's
// doubled cross terms: 4 * 2^61 + 2^60 + 9 * 2^58 + 2^35), so no carry is
// taken until the reduction.  The reduction works at radix 2^29, nine
// steps: m = (column i) * (-p^-1) mod 2^29, m p added at column i, the
// cleared column's carry (column >> 29, exact) added to column i + 1; one
// carry pass then leaves 9 limbs below 2^29.
//
// Montgomery radix 2^261: the value v stands for v * 2^-261 mod p, so an
// element x R mod p of the kernels' form (R = 2^256) is 32 x R, a 5-bit
// shift (fr29_from_fr), and comes back through one product by 2^256 mod p
// (fr29_to_fr).  Values are never reduced inside the chain: inputs below
// 2^260 give (a b + M p) / 2^261 < 2^259 + p, and an output plus a key
// below 32 p (added limb by limb, limbs below 2^30) stays below 2^260.
// tests/test_torch_fr_model.py models these limbs, columns and carries
// and asserts each bound.
#define FR29_LIMBS 9
#define FR29_COLS (2 * FR29_LIMBS - 1)
#define FR29_MASK 0x1fffffffu
#define FR_NP29 0x0fffffffu                 // -p^-1 mod 2^29

// p and 2^256 mod p in 29-bit limbs, least significant first.
static __constant__ uint32_t FR_P29[FR29_LIMBS] = {
    0x10000001u, 0x1f0fac9fu, 0x0e5c2450u, 0x07d090f3u, 0x1585d283u,
    0x02db40c0u, 0x00a6e141u, 0x0e5c2634u, 0x0030644eu};
static __constant__ uint32_t FR_C256_29[FR29_LIMBS] = {
    0x0ffffffbu, 0x04b1a0e2u, 0x18334a6bu, 0x18ed2b3eu, 0x1462e36fu,
    0x11b7bc3cu, 0x1cbd99bau, 0x183340fbu, 0x000e0a77u};

struct Fr29 {
  uint32_t l[FR29_LIMBS];
};

// The columns c of a product (value T < 2^520) -> T 2^-261 mod p, below
// T / 2^261 + p, limbs below 2^29.
__device__ __forceinline__ Fr29 fr29_redc(uint64_t c[FR29_COLS]) {
#pragma unroll
  for (int i = 0; i < FR29_LIMBS; ++i) {
    const uint32_t m = ((uint32_t)c[i] * FR_NP29) & FR29_MASK;
#pragma unroll
    for (int j = 0; j < FR29_LIMBS; ++j) c[i + j] += (uint64_t)m * FR_P29[j];
    c[i + 1] += c[i] >> 29;
  }
  Fr29 r;
  uint64_t v = c[FR29_LIMBS];
#pragma unroll
  for (int k = FR29_LIMBS + 1; k < FR29_COLS; ++k) {
    r.l[k - FR29_LIMBS - 1] = (uint32_t)v & FR29_MASK;
    v = c[k] + (v >> 29);
  }
  r.l[FR29_LIMBS - 2] = (uint32_t)v & FR29_MASK;
  r.l[FR29_LIMBS - 1] = (uint32_t)(v >> 29);
  return r;
}

// a b 2^-261 mod p, lazily: a, b below 2^260 with limbs below 2^30 ->
// below 2^259 + p, limbs below 2^29.
__device__ __forceinline__ Fr29 fr_mul_lat(const Fr29& a, const Fr29& b) {
  uint64_t c[FR29_COLS];
#pragma unroll
  for (int k = 0; k < FR29_COLS; ++k) c[k] = 0ull;
#pragma unroll
  for (int i = 0; i < FR29_LIMBS; ++i) {
#pragma unroll
    for (int j = 0; j < FR29_LIMBS; ++j) c[i + j] += (uint64_t)a.l[i] * b.l[j];
  }
  return fr29_redc(c);
}

// fr_mul_lat(a, a) with 45 limb products: the cross terms once, against
// the doubled limbs (below 2^31).
__device__ __forceinline__ Fr29 fr_sqr_lat(const Fr29& a) {
  uint64_t c[FR29_COLS];
#pragma unroll
  for (int k = 0; k < FR29_COLS; ++k) c[k] = 0ull;
  uint32_t d[FR29_LIMBS];
#pragma unroll
  for (int j = 0; j < FR29_LIMBS; ++j) d[j] = a.l[j] << 1;
#pragma unroll
  for (int i = 0; i < FR29_LIMBS; ++i) {
    c[2 * i] += (uint64_t)a.l[i] * a.l[i];
#pragma unroll
    for (int j = i + 1; j < FR29_LIMBS; ++j) c[i + j] += (uint64_t)a.l[i] * d[j];
  }
  return fr29_redc(c);
}

// x R mod p (canonical, 8 words) -> the limbs of 32 x R: limb k is bits
// [29k - 5, 29k + 24) of x R.
__device__ __forceinline__ Fr29 fr29_from_fr(const Fr& a) {
  Fr29 r;
  r.l[0] = (a.w[0] << 5) & FR29_MASK;
#pragma unroll
  for (int k = 1; k < FR29_LIMBS; ++k) {
    const int s = 29 * k - 5;
    const uint32_t hi = (s >> 5) + 1 < 8 ? a.w[(s >> 5) + 1] : 0u;
    r.l[k] = __funnelshift_r(a.w[s >> 5], hi, s & 31) & FR29_MASK;
  }
  return r;
}

// The way back: one product by 2^256 mod p gives x R mod p below
// 2^260 p / 2^261 + p = 1.5 p, which fits 8 words; one conditional
// subtraction.
__device__ __forceinline__ Fr fr29_to_fr(const Fr29& a) {
  Fr29 c;
#pragma unroll
  for (int k = 0; k < FR29_LIMBS; ++k) c.l[k] = FR_C256_29[k];
  const Fr29 v = fr_mul_lat(a, c);
  Fr r;
  uint64_t acc = 0ull;
  int bits = 0, q = 0;
#pragma unroll
  for (int k = 0; k < FR29_LIMBS; ++k) {
    acc |= (uint64_t)v.l[k] << bits;
    bits += 29;
    if (bits >= 32) {
      r.w[q++] = (uint32_t)acc;
      acc >>= 32;
      bits -= 32;
    }
  }
  return fr_reduce_once(r);
}

// Limb by limb, no carry: two values with limbs below 2^29 -> limbs below
// 2^30 (the hash's h + kc, below 2^259 + p + 32 p < 2^260).
__device__ __forceinline__ Fr29 fr29_add_lazy(const Fr29& a, const Fr29& b) {
  Fr29 r;
#pragma unroll
  for (int k = 0; k < FR29_LIMBS; ++k) r.l[k] = a.l[k] + b.l[k];
  return r;
}

// x^7 in three dependent products: x^2, then x^3 = x^2 x and x^4 = x^2 x^2
// (independent of each other, so their limb products interleave), then
// x^3 x^4; x^2 and x^4 are squares.
__device__ __forceinline__ Fr29 fr_pow7(const Fr29& x) {
  const Fr29 x2 = fr_sqr_lat(x);
  const Fr29 x3 = fr_mul_lat(x2, x);
  const Fr29 x4 = fr_sqr_lat(x2);
  return fr_mul_lat(x3, x4);
}
