// The port bench's probe kernels for Hopper (sm_90a), bound to Python through
// a plain C interface like kernels.cu (ctypes, gkr_tpu_torch.torcheng.kernels).
//
//   gkr_u32_mul_chain  8 u32 multiply chains an element, summed    bench.py _measure_vpu_peak
//   gkr_micro_op       REPS of one u32/i32/f32 op an element       scripts/micro_vpu.py make_bench
//   gkr_mont_chain     x <- x * b / R, DEPTH times, by variant     scripts/tune_pallas_mul.py build
//                      (cios32, school, lat, f64, cc)
//
// Each launcher enqueues on the given stream, allocates nothing, and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a parameter it has no
// instantiation of.
//
// The integer chains are written in inline PTX (`asm volatile`): products
// mod 2^32 associate, so with the repetition count a compile-time constant
// the compiler would be free to rewrite acc * b * ... * b as acc * b^REPS by
// squaring, and the "measured peak" would count products the card never
// issued.  The SASS of each instantiation is counted by
// gkr_tpu_torch.probes.sass_counts to show that it did not.  Inline PTX is
// not enough for the eight chains of the peak probe, which share their
// multiplier: ptxas still reassociated `mul.lo.u32` across them, and the
// SASS held one IMAD a repetition instead of eight.  There every
// product is a multiply-add of a runtime zero (`mad.lo.u32 acc, acc, b,
// zero`): the same value and the same one IMAD, but no compiler can factor
// b^REPS out of acc * b + zero without knowing that zero is 0.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fr.cuh"

#define PROBE_THREADS 256
#define CHAINS 8

static inline unsigned probe_blocks(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// a * b + zero mod 2^32: one IMAD, opaque to the compiler's algebra.
__device__ __forceinline__ uint32_t mad_lo(uint32_t a, uint32_t b, uint32_t zero) {
  uint32_t r;
  asm volatile("mad.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(zero));
  return r;
}

// ---------------------------------------------------------- u32 peak probe
// out[i] = sum_c (a[i] + c) * b[i]^REPS mod 2^32 over CHAINS = 8 independent
// accumulators, so that eight products are in flight in every thread.
// `zero` is 0 at run time (see the note at the top).
template <int REPS>
__global__ void __launch_bounds__(PROBE_THREADS)
k_u32_mul_chain(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                uint32_t* __restrict__ out, long long n, uint32_t zero) {
  long long i = (long long)blockIdx.x * PROBE_THREADS + threadIdx.x;
  if (i >= n) return;
  const uint32_t x = a[i], y = b[i];
  uint32_t acc[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) acc[c] = x + (uint32_t)c;
#pragma unroll
  for (int r = 0; r < REPS; ++r) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) acc[c] = mad_lo(acc[c], y, zero);
  }
  uint32_t s = acc[0];
#pragma unroll
  for (int c = 1; c < CHAINS; ++c) s += acc[c];
  out[i] = s;
}

// ------------------------------------------------------------ per-op probe
// acc = a; REPS times acc = op(acc, b[, a]); out = acc.  Elements are 32-bit
// words: u32 and i32 bit patterns, or f32.
enum {
  OP_U32_ADD = 0,
  OP_U32_MUL = 1,
  OP_U32_MUL16 = 2,
  OP_U32_SHIFT = 3,
  OP_I32_MUL = 4,
  OP_F32_MUL = 5,
  OP_F32_FMA = 6
};

template <int OP, int REPS>
__global__ void __launch_bounds__(PROBE_THREADS)
k_micro_op(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
           uint32_t* __restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * PROBE_THREADS + threadIdx.x;
  if (i >= n) return;
  const uint32_t x = a[i], y = b[i];
  uint32_t acc = x;
#pragma unroll
  for (int r = 0; r < REPS; ++r) {
    if constexpr (OP == OP_U32_ADD) {
      asm volatile("add.u32 %0, %0, %1;" : "+r"(acc) : "r"(y));
    } else if constexpr (OP == OP_U32_MUL) {
      asm volatile("mul.lo.u32 %0, %0, %1;" : "+r"(acc) : "r"(y));
    } else if constexpr (OP == OP_U32_MUL16) {
      asm volatile("{\n\t.reg .u32 t, u;\n\t"
                   "and.b32 t, %0, 65535;\n\tand.b32 u, %1, 65535;\n\t"
                   "mul.lo.u32 %0, t, u;\n\t}"
                   : "+r"(acc) : "r"(y));
    } else if constexpr (OP == OP_U32_SHIFT) {
      asm volatile("{\n\t.reg .u32 t;\n\tshr.u32 t, %0, 16;\n\t"
                   "add.u32 %0, t, %1;\n\t}"
                   : "+r"(acc) : "r"(y));
    } else if constexpr (OP == OP_I32_MUL) {
      asm volatile("mul.lo.s32 %0, %0, %1;" : "+r"(acc) : "r"(y));
    } else if constexpr (OP == OP_F32_MUL) {
      // rounded multiply: never contracted into an FMA
      acc = __float_as_uint(__fmul_rn(__uint_as_float(acc), __uint_as_float(y)));
    } else {
      acc = __float_as_uint(fmaf(__uint_as_float(acc), __uint_as_float(y),
                                 __uint_as_float(x)));
    }
  }
  out[i] = acc;
}

// --------------------------------------------------- Montgomery variants
// The separated schoolbook: the full 8 x 8-word product into 16 words, then
// one Montgomery reduction (fr_redc_wide).  a, b < p, so a * b < p * 2^256,
// within fr_redc_wide's contract; the result equals fr_mul's.
__device__ __forceinline__ Fr fr_mul_school(const Fr& a, const Fr& b) {
  uint32_t T[17];
#pragma unroll
  for (int j = 0; j < 17; ++j) T[j] = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t s = (uint64_t)T[i + j] + (uint64_t)a.w[j] * b.w[i] + c;
      T[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    T[i + 8] = (uint32_t)c;
  }
  return fr_redc_wide(T);
}

// VARIANT 0: CIOS (fr_mul_cios32); 1: separated schoolbook; 2: the hash's
// latency-first product (fr_mul_lat on Fr29 limbs: x and b converted once,
// DEPTH products, x converted back); 3: the FP64 product (fr_mul_f64: b
// converted to 52-bit limbs once, x each product); 4: CIOS with its carries
// in the multiply-adds (fr_mul_cc, the throughput kernels' fr_mul).
// x = a[i]; DEPTH times x = x * b[i] / R; out[i] = x.  BLOCK threads a
// block, so the register budget follows the block width as a Pallas block
// would.  At one element the chain is one thread's dependent products: its
// marginal time between the depths is a product's latency.
template <int VARIANT, int DEPTH, int BLOCK>
__global__ void __launch_bounds__(BLOCK)
k_mont_chain(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
             uint32_t* __restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  Fr x = fr_load(a + 16 * i);
  const Fr y = fr_load(b + 16 * i);
  if constexpr (VARIANT == 2) {
    Fr29 x29 = fr29_from_fr(x);
    const Fr29 y29 = fr29_from_fr(y);
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) x29 = fr_mul_lat(x29, y29);
    x = fr29_to_fr(x29);
  } else if constexpr (VARIANT == 3) {
    const Fr52 y52 = fr52_from_fr(y);
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) x = fr_mul_f64(x, y52);
  } else {
#pragma unroll
    for (int d = 0; d < DEPTH; ++d)
      x = VARIANT == 0   ? fr_mul_cios32(x, y)
          : VARIANT == 1 ? fr_mul_school(x, y)
                         : fr_mul_cc(x, y);
  }
  fr_store(out + 16 * i, x);
}

// ---------------------------------------------------------------- launchers
template <int REPS>
static int launch_mul_chain(const void* a, const void* b, void* out,
                            long long n, cudaStream_t s) {
  k_u32_mul_chain<REPS><<<probe_blocks(n, PROBE_THREADS), PROBE_THREADS, 0, s>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, 0u);
  return (int)cudaGetLastError();
}

template <int OP>
static int launch_micro(const void* a, const void* b, void* out, long long n,
                        int reps, cudaStream_t s) {
  const unsigned g = probe_blocks(n, PROBE_THREADS);
  if (reps == 16) {
    k_micro_op<OP, 16><<<g, PROBE_THREADS, 0, s>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  } else if (reps == 1040) {
    k_micro_op<OP, 1040><<<g, PROBE_THREADS, 0, s>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  } else if (reps == 4112) {
    k_micro_op<OP, 4112><<<g, PROBE_THREADS, 0, s>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int VARIANT, int DEPTH>
static int launch_chain(const void* a, const void* b, void* out, long long n,
                        int block, cudaStream_t s) {
  const uint32_t* pa = (const uint32_t*)a;
  const uint32_t* pb = (const uint32_t*)b;
  uint32_t* po = (uint32_t*)out;
  switch (block) {
    case 128:
      k_mont_chain<VARIANT, DEPTH, 128><<<probe_blocks(n, 128), 128, 0, s>>>(pa, pb, po, n);
      break;
    case 256:
      k_mont_chain<VARIANT, DEPTH, 256><<<probe_blocks(n, 256), 256, 0, s>>>(pa, pb, po, n);
      break;
    case 512:
      k_mont_chain<VARIANT, DEPTH, 512><<<probe_blocks(n, 512), 512, 0, s>>>(pa, pb, po, n);
      break;
    case 1024:
      k_mont_chain<VARIANT, DEPTH, 1024><<<probe_blocks(n, 1024), 1024, 0, s>>>(pa, pb, po, n);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" {

int gkr_u32_mul_chain(const void* a, const void* b, void* out, long long n,
                      int reps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (reps == 16) return launch_mul_chain<16>(a, b, out, n, s);
  if (reps == 128) return launch_mul_chain<128>(a, b, out, n, s);
  return (int)cudaErrorInvalidValue;
}

int gkr_micro_op(const void* a, const void* b, void* out, long long n, int op,
                 int reps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case OP_U32_ADD: return launch_micro<OP_U32_ADD>(a, b, out, n, reps, s);
    case OP_U32_MUL: return launch_micro<OP_U32_MUL>(a, b, out, n, reps, s);
    case OP_U32_MUL16: return launch_micro<OP_U32_MUL16>(a, b, out, n, reps, s);
    case OP_U32_SHIFT: return launch_micro<OP_U32_SHIFT>(a, b, out, n, reps, s);
    case OP_I32_MUL: return launch_micro<OP_I32_MUL>(a, b, out, n, reps, s);
    case OP_F32_MUL: return launch_micro<OP_F32_MUL>(a, b, out, n, reps, s);
    case OP_F32_FMA: return launch_micro<OP_F32_FMA>(a, b, out, n, reps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int gkr_mont_chain(const void* a, const void* b, void* out, long long n,
                   int variant, int depth, int block, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 0 && depth == 1) return launch_chain<0, 1>(a, b, out, n, block, s);
  if (variant == 0 && depth == 9) return launch_chain<0, 9>(a, b, out, n, block, s);
  if (variant == 1 && depth == 1) return launch_chain<1, 1>(a, b, out, n, block, s);
  if (variant == 1 && depth == 9) return launch_chain<1, 9>(a, b, out, n, block, s);
  if (variant == 2 && depth == 1) return launch_chain<2, 1>(a, b, out, n, block, s);
  if (variant == 2 && depth == 9) return launch_chain<2, 9>(a, b, out, n, block, s);
  if (variant == 3 && depth == 1) return launch_chain<3, 1>(a, b, out, n, block, s);
  if (variant == 3 && depth == 9) return launch_chain<3, 9>(a, b, out, n, block, s);
  if (variant == 4 && depth == 1) return launch_chain<4, 1>(a, b, out, n, block, s);
  if (variant == 4 && depth == 9) return launch_chain<4, 9>(a, b, out, n, block, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
