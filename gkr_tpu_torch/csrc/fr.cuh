// BN254 scalar field (Fr) arithmetic on the device, Montgomery form with
// R = 2^256, the same representation as gkr_tpu_torch.torcheng.limbs.
//
// Storage (what the kernels read and write): one element is 16 uint32 slots,
// each holding a 16-bit limb, least significant first -- 64 bytes, the
// layout of the port's int32 limb tensors.  Inside a thread an element is
// repacked into 8 32-bit words (Fr).  R is 2^256 for every product here, so
// results are the same canonical values as the 16-bit reference.
//
// Three Montgomery products of canonical values (a below 3p, b below p),
// bit-equal by construction:
//   fr_mul_cios32  CIOS on 8 x 32-bit words, carries as 64-bit sums
//                  (the factor is -p^-1 mod 2^32, FR_NPRIME32, not the
//                  16-bit one);
//   fr_mul_cc      the same CIOS with its carries in the multiply-adds
//                  (PTX madc chains, even and odd column accumulators);
//   fr_mul_f64     on the FP64 pipe: 52-bit limbs as doubles, exact FMA
//                  splits, 64-bit integer columns.
// fr_mul, the throughput kernels' product, is fr_mul_cc: the fastest of
// them in a chain of products on the card (`probes tune`, PERF.md section 6).
//
// Every Fr a function here takes or returns is canonical (< p) unless it
// says otherwise.  The hash runs on its own representation, Fr29, at the
// end of this file.
#pragma once

#include <stdint.h>

// p = 21888242871839275222246405745257275088548364400416034343698204186575808495617,
// 32-bit words, least significant first.
static __constant__ uint32_t FR_P[8] = {
    0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
    0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};

// p's words as immediates (the cc product's PTX chains)
#define FR_P0 0xf0000001u
#define FR_P1 0x43e1f593u
#define FR_P2 0x79b97091u
#define FR_P3 0x2833e848u
#define FR_P4 0x8181585du
#define FR_P5 0xb85045b6u
#define FR_P6 0xe131a029u
#define FR_P7 0x30644e72u

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

// 2a - b + p for canonical a, b: a value below 3p, not reduced (an operand
// of fr_mul, which takes one below 3p).
__device__ __forceinline__ Fr fr_twice_minus(const Fr& a, const Fr& b) {
  Fr d;
  uint32_t borrow = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t v = (uint64_t)FR_P[j] - b.w[j] - borrow;
    d.w[j] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  uint32_t carry = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t v = (uint64_t)d.w[j] + a.w[j] + a.w[j] + carry;
    d.w[j] = (uint32_t)v;
    carry = (uint32_t)(v >> 32);
  }
  return d;
}

// Montgomery product a * b / 2^256 mod p (CIOS, 8 x 32-bit words).
// Per product: 64 + 64 32x32->64-bit multiply-adds and 8 low multiplies.
// Each 64-bit sum t + x*y + c is at most 2^64 - 1, so no sum overflows.
// a may be any value below 3p (b below p): the result, below
// a b / 2^256 + p < 1.57 p, is still canonical after one subtraction.
__device__ __forceinline__ Fr fr_mul_cios32(const Fr& a, const Fr& b) {
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

// ---------------------------------------------------------------------- cc
// fr_mul_cios32's CIOS with the carries in the multiply-adds: PTX
// mad.lo.cc / madc.hi.cc chains, so that a word product's carry costs no
// instruction of its own (the shape of Supranational's sppark mont_t).  The
// partial sum T is held as two accumulators: ev with column k at word k and
// od with column k + 1 at word k.  The products of a's even words have their
// low halves at even columns and their high halves at odd ones, so
// sum_j a_2j b_i 2^(64 j) is one 8-word number, added to ev by one carry
// chain; a's odd words go to od the same way.  After m p clears column 0 the
// shift by one word swaps the roles: od is then the even-column accumulator
// and ev, from its word 1 on, the odd one.  T stays below (a + p) 2^32 <
// 2^288 (a < 3p, 4p < 2^256), so od, which holds T's words 1..8, never
// carries out of its top word; tests/test_torch_fr_mul_model.py runs the
// chains on an explicit carry flag and asserts it.

// One CIOS word: T += a b_i, m = T_0 (-p^-1), T += m p; ev's word 0 is then 0.
__device__ __forceinline__ void cc_step(uint32_t* ev, uint32_t* od, const uint32_t* a,
                                        uint32_t bi, bool first) {
  if (first) {
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      od[j] = a[j + 1] * bi;
      od[j + 1] = __umulhi(a[j + 1], bi);
      ev[j] = a[j] * bi;
      ev[j + 1] = __umulhi(a[j], bi);
    }
  } else {
    // ev's column 0 takes od's word 1 (the old ev's column 1); od shifts
    // down two words (one for the step, one for the role swap) while it
    // takes a's odd words times b_i; the carry out of ev's first add rides
    // the same chain
    asm("add.cc.u32 %0, %0, %2;\n\t"
        "madc.lo.cc.u32 %1, %9, %13, %3;\n\t"
        "madc.hi.cc.u32 %2, %9, %13, %4;\n\t"
        "madc.lo.cc.u32 %3, %10, %13, %5;\n\t"
        "madc.hi.cc.u32 %4, %10, %13, %6;\n\t"
        "madc.lo.cc.u32 %5, %11, %13, %7;\n\t"
        "madc.hi.cc.u32 %6, %11, %13, %8;\n\t"
        "madc.lo.cc.u32 %7, %12, %13, 0;\n\t"
        "madc.hi.u32 %8, %12, %13, 0;"
        : "+r"(ev[0]), "+r"(od[0]), "+r"(od[1]), "+r"(od[2]), "+r"(od[3]),
          "+r"(od[4]), "+r"(od[5]), "+r"(od[6]), "+r"(od[7])
        : "r"(a[1]), "r"(a[3]), "r"(a[5]), "r"(a[7]), "r"(bi));
    // ev += a's even words times b_i; the carry out goes to od's top word
    asm("mad.lo.cc.u32 %0, %9, %13, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"
        "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
        "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
        "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
        "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
        "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
        "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
        "addc.u32 %8, %8, 0;"
        : "+r"(ev[0]), "+r"(ev[1]), "+r"(ev[2]), "+r"(ev[3]), "+r"(ev[4]),
          "+r"(ev[5]), "+r"(ev[6]), "+r"(ev[7]), "+r"(od[7])
        : "r"(a[0]), "r"(a[2]), "r"(a[4]), "r"(a[6]), "r"(bi));
  }
  const uint32_t mi = ev[0] * FR_NPRIME32;
  // od += p's odd words times m; od's top word never carries out
  asm("mad.lo.cc.u32 %0, %8, %9, %0;\n\t"
      "madc.hi.cc.u32 %1, %8, %9, %1;\n\t"
      "madc.lo.cc.u32 %2, %8, %10, %2;\n\t"
      "madc.hi.cc.u32 %3, %8, %10, %3;\n\t"
      "madc.lo.cc.u32 %4, %8, %11, %4;\n\t"
      "madc.hi.cc.u32 %5, %8, %11, %5;\n\t"
      "madc.lo.cc.u32 %6, %8, %12, %6;\n\t"
      "madc.hi.u32 %7, %8, %12, %7;"
      : "+r"(od[0]), "+r"(od[1]), "+r"(od[2]), "+r"(od[3]), "+r"(od[4]),
        "+r"(od[5]), "+r"(od[6]), "+r"(od[7])
      : "r"(mi), "n"(FR_P1), "n"(FR_P3), "n"(FR_P5), "n"(FR_P7));
  // ev += p's even words times m, clearing ev's word 0; the carry to od's top
  asm("mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %10, %1;\n\t"
      "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
      "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
      "madc.lo.cc.u32 %4, %9, %12, %4;\n\t"
      "madc.hi.cc.u32 %5, %9, %12, %5;\n\t"
      "madc.lo.cc.u32 %6, %9, %13, %6;\n\t"
      "madc.hi.cc.u32 %7, %9, %13, %7;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(ev[0]), "+r"(ev[1]), "+r"(ev[2]), "+r"(ev[3]), "+r"(ev[4]),
        "+r"(ev[5]), "+r"(ev[6]), "+r"(ev[7]), "+r"(od[7])
      : "r"(mi), "n"(FR_P0), "n"(FR_P2), "n"(FR_P4), "n"(FR_P6));
}

// a * b / 2^256 mod p, a below 3p, b below p (fr_mul_cios32's contract and
// result); 8 steps, the accumulators swapping roles each step, then od
// (column k at word k - 1 by now) merged into ev and one subtraction.
__device__ __forceinline__ Fr fr_mul_cc(const Fr& a, const Fr& b) {
  uint32_t ev[8], od[8];
#pragma unroll
  for (int i = 0; i < 8; i += 2) {
    cc_step(ev, od, a.w, b.w[i], i == 0);
    cc_step(od, ev, a.w, b.w[i + 1], false);
  }
  Fr r;
  asm("add.cc.u32 %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32 %7, %7, 0;"
      : "+r"(ev[0]), "+r"(ev[1]), "+r"(ev[2]), "+r"(ev[3]), "+r"(ev[4]),
        "+r"(ev[5]), "+r"(ev[6]), "+r"(ev[7])
      : "r"(od[1]), "r"(od[2]), "r"(od[3]), "r"(od[4]), "r"(od[5]),
        "r"(od[6]), "r"(od[7]));
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = ev[j];
  return fr_reduce_once(r);
}

// --------------------------------------------------------------------- f64
// The product on the FP64 pipe, after Emmart, Zheng and Weems, "Faster
// Modular Exponentiation Using Double Precision Floating Point Arithmetic
// on the GPU" (ARITH 2018).  The integer pipes carry every other product
// here; the FP64 pipe, as wide as the IMAD pipe on an H100 (64 lanes an
// SM), was idle.  tests/test_torch_fr_mul_model.py models every step below
// and asserts each bound stated here.
//
// Limbs: an element below 2^256 is 5 limbs of 52 bits, each an exact double
// (Fr52; the top limb below 2^48).  A limb product x y < 2^104 is split
// exactly by two FMAs (f52_mac):
//   hi  = fma_rz(x, y, 2^104): x y + 2^104 lies in [2^104, 2^105), where a
//         double's ulp is 2^52, so rounding toward zero gives 2^104 + H 2^52
//         with H = floor(x y / 2^52), and hi's bits are those of 2^104 plus H;
//   sub = (2^104 + 2^52) - hi = (1 - H) 2^52: a difference of 53 bits,
//         exact;
//   lo  = fma(x, y, sub) = L + 2^52 with L = x y - H 2^52 in [0, 2^52):
//         the exact result lies in [2^52, 2^53), where the ulp is 1, so it
//         is exact, and lo's bits are those of 2^52 plus L.
// Columns: x y's parts go to 64-bit integer columns c (L) and c + 1 (H) as
// the doubles' bit patterns.  Each column starts at minus the exponent bits
// of all the patterns it will take (f52_col_init), so once they are in it
// holds the true sum; the exponent bits are multiples of 2^52, so its low
// 52 bits are exact at any time.  A column takes at most 18 terms below
// 2^52 and a carry below 2^6: below 2^57, far from 2^64.
// Reduction, product scanning: column c takes its limb products and the
// terms m_k p_(c-k) of the factors already taken; for c < 5 it then takes
// m_c = (column c mod 2^52) (-p^-1) mod 2^52 -- with integer multiplies, as
// an exact double through the 2^52 offset -- and m_c p_0, which clears its
// low 52 bits; every column then carries c >> 52 into the next.  The last
// step clears 48 bits with a 48-bit m: 4 x 52 + 48 = 256, so the radix stays
// R = 2^256 and nothing outside the product changes.  The result is T /
// 2^256 = (column 4 >> 48) + 16 (columns 5..9 at 52 bits a column), below
// a b / 2^256 + p < 1.57 p for a below 3p and b below p; one subtraction.
#define F52_LIMBS 5
#define F52_COLS (2 * F52_LIMBS)
#define F52_MASK 0xfffffffffffffull          // 2^52 - 1
#define F52_NP 0x1f593efffffffull            // -p^-1 mod 2^52
#define F52_LO_BITS 0x4330000000000000ull    // the bits of the double 2^52
#define F52_HI_BITS 0x4670000000000000ull    // the bits of the double 2^104

// p in 52-bit limbs, least significant first
static __constant__ double FR_P52[F52_LIMBS] = {
    (double)0x1f593f0000001ull, (double)0x4879b9709143eull,
    (double)0x181585d2833e8ull, (double)0xa029b85045b68ull,
    (double)0x30644e72e131ull};

struct Fr52 {
  double d[F52_LIMBS];
};

// limb pairs (i, j), 0 <= i, j < 5, with i + j = s
__host__ __device__ constexpr int f52_pairs(int s) {
  return s < 0 || s > 2 * (F52_LIMBS - 1)
             ? 0
             : (s < F52_LIMBS - 1 ? s : 2 * (F52_LIMBS - 1) - s) + 1;
}

// Column c's start: minus the exponent bits of its patterns, mod 2^64 --
// 2 pairs(c) low parts and 2 pairs(c - 1) high ones, the product's and the
// reduction's.
__host__ __device__ constexpr unsigned long long f52_col_init(int c) {
  return 0ull - (unsigned long long)(2 * f52_pairs(c)) * F52_LO_BITS -
         (unsigned long long)(2 * f52_pairs(c - 1)) * F52_HI_BITS;
}

// The limb hi20:lo32 as an exact double: the bits 0x433 | limb are 2^52 +
// limb, and the subtraction of 2^52 is exact.
__device__ __forceinline__ double f52_double(uint32_t lo32, uint32_t hi20) {
  return __dsub_rn(__hiloint2double((int)(hi20 | 0x43300000u), (int)lo32), 0x1p52);
}

// 8 words (value below 2^256) -> limb i = bits [52 i, 52 i + 52)
__device__ __forceinline__ Fr52 fr52_from_fr(const Fr& x) {
  Fr52 r;
  r.d[0] = f52_double(x.w[0], x.w[1] & 0xfffffu);
  r.d[1] = f52_double(__funnelshift_r(x.w[1], x.w[2], 20),
                      __funnelshift_r(x.w[2], x.w[3], 20) & 0xfffffu);
  r.d[2] = f52_double(__funnelshift_r(x.w[3], x.w[4], 8),
                      __funnelshift_r(x.w[4], x.w[5], 8) & 0xfffffu);
  r.d[3] = f52_double(__funnelshift_r(x.w[4], x.w[5], 28),
                      __funnelshift_r(x.w[5], x.w[6], 28) & 0xfffffu);
  r.d[4] = f52_double(__funnelshift_r(x.w[6], x.w[7], 16), x.w[7] >> 16);
  return r;
}

// x y (x, y < 2^52, exact) into col[c] (its low 52 bits) and col[c + 1]
// (the rest), as the note above splits it.
__device__ __forceinline__ void f52_mac(unsigned long long* col, int c, double x,
                                        double y) {
  const double hi = __fma_rz(x, y, 0x1p104);
  const double lo = __fma_rn(x, y, __dsub_rn(0x1p104 + 0x1p52, hi));
  col[c] += (unsigned long long)__double_as_longlong(lo);
  col[c + 1] += (unsigned long long)__double_as_longlong(hi);
}

// a * b / 2^256 mod p, a below 3p (8 words), b below p (as limbs).
__device__ __forceinline__ Fr fr_mul_f64(const Fr& a, const Fr52& b) {
  const Fr52 x = fr52_from_fr(a);
  unsigned long long col[F52_COLS];
#pragma unroll
  for (int c = 0; c < F52_COLS; ++c) col[c] = f52_col_init(c);
  double m[F52_LIMBS];
#pragma unroll
  for (int c = 0; c < F52_COLS; ++c) {
#pragma unroll
    for (int i = 0; i < F52_LIMBS; ++i)
      if (c - i >= 0 && c - i < F52_LIMBS) f52_mac(col, c, x.d[i], b.d[c - i]);
#pragma unroll
    for (int k = 0; k < F52_LIMBS; ++k)
      if (k < c && c - k < F52_LIMBS) f52_mac(col, c, m[k], FR_P52[c - k]);
    if (c < F52_LIMBS) {
      const unsigned long long mc =
          (col[c] * F52_NP) & (c < F52_LIMBS - 1 ? F52_MASK : 0xffffffffffffull);
      m[c] = __dsub_rn(__longlong_as_double((long long)(mc | F52_LO_BITS)), 0x1p52);
      f52_mac(col, c, m[c], FR_P52[0]);
    }
    if (c < F52_COLS - 1) col[c + 1] += col[c] >> 52;
  }
  // columns 5..9 to 52 bits (the carries above), then T / 2^256 =
  // low4 + 16 (c5 + 2^52 c6 + ... + 2^208 c9) into 8 words
  const unsigned long long low4 = (col[4] >> 48) & 15ull;
  const unsigned long long c5 = col[5] & F52_MASK, c6 = col[6] & F52_MASK,
                           c7 = col[7] & F52_MASK, c8 = col[8] & F52_MASK, c9 = col[9];
  Fr r;
  r.w[0] = (uint32_t)(low4 | (c5 << 4));
  r.w[1] = (uint32_t)((c5 >> 28) | (c6 << 24));
  r.w[2] = (uint32_t)(c6 >> 8);
  r.w[3] = (uint32_t)((c6 >> 40) | (c7 << 12));
  r.w[4] = (uint32_t)(c7 >> 20);
  r.w[5] = (uint32_t)c8;
  r.w[6] = (uint32_t)((c8 >> 32) | (c9 << 20));
  r.w[7] = (uint32_t)(c9 >> 12);
  return fr_reduce_once(r);
}

// The throughput kernels' product: a * b / 2^256 mod p, a below 3p, b
// below p, canonical.  cc: per product 317 SASS instructions, 151.625 of
// the IMAD family (119 IMAD.WIDE, 9 IMAD.HI), no FP64; cios32 583 and
// 232.125 (120 IMAD.WIDE), f64 393 and 30 beside 159.5 on the FP64 pipe
// (`probes.sass_summary`).  In a chain of products over 2^20 elements on
// an H100 it runs about 0.015 ms a pass against f64's 0.017 and cios32's
// 0.026 (`probes tune`, PERF.md section 6).
__device__ __forceinline__ Fr fr_mul(const Fr& a, const Fr& b) {
  return fr_mul_cc(a, b);
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
// is bound by its wide multiplies and by the carries around them.
// fr_mul_cios32 spends 583 instructions (120 IMAD.WIDE) and ~1300 SM clocks
// a dependent product (`probes tune`), most of it on 64-bit carry chains;
// fr_mul (cc) 317 instructions (119 IMAD.WIDE) and ~1100 clocks, which
// would save under 10% a product here and give up the squares' savings
// below.  Here an element is 9 limbs of 29 bits
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
