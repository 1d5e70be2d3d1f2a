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
// Every value a function here takes or returns is canonical (< p).
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

// x^7: four dependent products (x^2, x^4, x^6, x^7).
__device__ __forceinline__ Fr fr_pow7(const Fr& x) {
  Fr x2 = fr_mul(x, x);
  Fr x4 = fr_mul(x2, x2);
  Fr x6 = fr_mul(x4, x2);
  return fr_mul(x6, x);
}
