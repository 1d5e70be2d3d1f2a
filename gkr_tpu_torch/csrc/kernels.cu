// The per-round layer sumcheck's kernels for Hopper (sm_90a), bound to
// Python through a plain C interface (ctypes, gkr_tpu_torch.torcheng.kernels).
//
// Each launcher takes device pointers to int32 limb tensors (16 limbs of 16
// bits per field element, row-major, 64 bytes an element), enqueues on the
// given stream, allocates nothing, and returns cudaGetLastError().
//
//   gkr_mont_mul        a * b / R elementwise        pallas_kernels.pl_mont_mul_T
//   gkr_fold            lo + r * (hi - lo)           pallas_kernels.pl_fold
//   gkr_phase1_partials per-block sums of g(0,1,2)   pallas_kernels.pl_phase1_eval
//   gkr_phase2_partials per-block sums of g(0,1,2)   pallas_kernels.pl_phase2_eval
//
// Stacked tables keep the JAX per-round engine's (n, T, 16) layout: entry s
// of table t is element s*T + t, and the MSB variable splits the table axis
// into lo = entries [0, n/2) and hi = entries [n/2, n).
#include <cuda_runtime.h>
#include <stdint.h>

#include "fr.cuh"

#define THREADS 256

// ---------------------------------------------------------------- mont_mul
// out[i] = a[i] * b[i / b_div] / R.  b_div = 1: elementwise; b_div = n: one
// scalar for all; otherwise each b row serves b_div consecutive a rows.
__global__ void __launch_bounds__(THREADS)
k_mont_mul(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
           uint32_t* __restrict__ out, long long n, long long b_div) {
  long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  Fr x = fr_load(a + 16 * i);
  Fr y = fr_load(b + 16 * (i / b_div));
  fr_store(out + 16 * i, fr_mul(x, y));
}

// -------------------------------------------------------------------- fold
// m = (n/2) * T elements of output; lo is element i, hi is element i + m.
__global__ void __launch_bounds__(THREADS)
k_fold(const uint32_t* __restrict__ S, const uint32_t* __restrict__ r,
       uint32_t* __restrict__ out, long long m) {
  long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= m) return;
  Fr rr = fr_load(r);
  Fr lo = fr_load(S + 16 * i);
  Fr hi = fr_load(S + 16 * (i + m));
  fr_store(out + 16 * i, fr_add(lo, fr_mul(fr_sub(hi, lo), rr)));
}

// ------------------------------------------------------- eval block sums
// Each block folds its threads' canonical sums by a tree of field adds in
// shared memory and writes one (3, 16) canonical partial.
__device__ __forceinline__ void block_reduce_store(Fr acc[3],
                                                   uint32_t* partials) {
  __shared__ Fr sh[3][THREADS];
  const int tid = threadIdx.x;
#pragma unroll
  for (int t = 0; t < 3; ++t) sh[t][tid] = acc[t];
  __syncthreads();
  for (int off = THREADS / 2; off > 0; off >>= 1) {
    if (tid < off) {
#pragma unroll
      for (int t = 0; t < 3; ++t) sh[t][tid] = fr_add(sh[t][tid], sh[t][tid + off]);
    }
    __syncthreads();
  }
  if (tid == 0) {
#pragma unroll
    for (int t = 0; t < 3; ++t) fr_store(partials + 48 * blockIdx.x + 16 * t, sh[t][0]);
  }
}

// S: (n, 4, 16) = [W, HA1, HA2, HM]; half = n/2.
// y_t = sum_s (HA1_t + HM_t) * W_t + HA2_t, X_0 = lo, X_1 = hi, X_2 = 2hi - lo.
__global__ void __launch_bounds__(THREADS)
k_phase1_partials(const uint32_t* __restrict__ S, uint32_t* __restrict__ partials,
                  long long half) {
  Fr acc[3] = {fr_zero(), fr_zero(), fr_zero()};
  for (long long s = (long long)blockIdx.x * THREADS + threadIdx.x; s < half;
       s += (long long)gridDim.x * THREADS) {
    const uint32_t* lo = S + 64 * s;
    const uint32_t* hi = S + 64 * (s + half);
    Fr w0 = fr_load(lo), a0 = fr_load(lo + 16), h0 = fr_load(lo + 32), m0 = fr_load(lo + 48);
    Fr w1 = fr_load(hi), a1 = fr_load(hi + 16), h1 = fr_load(hi + 32), m1 = fr_load(hi + 48);
    acc[0] = fr_add(acc[0], fr_add(fr_mul(fr_add(a0, m0), w0), h0));
    acc[1] = fr_add(acc[1], fr_add(fr_mul(fr_add(a1, m1), w1), h1));
    Fr w2 = fr_add(w1, fr_sub(w1, w0));
    Fr a2 = fr_add(a1, fr_sub(a1, a0));
    Fr h2 = fr_add(h1, fr_sub(h1, h0));
    Fr m2 = fr_add(m1, fr_sub(m1, m0));
    acc[2] = fr_add(acc[2], fr_add(fr_mul(fr_add(a2, m2), w2), h2));
  }
  block_reduce_store(acc, partials);
}

// S: (n, 3, 16) = [W, FA, FMwb]; wb: one element.
// y_t = sum_s FA_t * (wb + W_t) + FMwb_t * W_t.
__global__ void __launch_bounds__(THREADS)
k_phase2_partials(const uint32_t* __restrict__ S, const uint32_t* __restrict__ wbp,
                  uint32_t* __restrict__ partials, long long half) {
  Fr wb = fr_load(wbp);
  Fr acc[3] = {fr_zero(), fr_zero(), fr_zero()};
  for (long long s = (long long)blockIdx.x * THREADS + threadIdx.x; s < half;
       s += (long long)gridDim.x * THREADS) {
    const uint32_t* lo = S + 48 * s;
    const uint32_t* hi = S + 48 * (s + half);
    Fr w0 = fr_load(lo), f0 = fr_load(lo + 16), g0 = fr_load(lo + 32);
    Fr w1 = fr_load(hi), f1 = fr_load(hi + 16), g1 = fr_load(hi + 32);
    acc[0] = fr_add(acc[0], fr_add(fr_mul(f0, fr_add(wb, w0)), fr_mul(g0, w0)));
    acc[1] = fr_add(acc[1], fr_add(fr_mul(f1, fr_add(wb, w1)), fr_mul(g1, w1)));
    Fr w2 = fr_add(w1, fr_sub(w1, w0));
    Fr f2 = fr_add(f1, fr_sub(f1, f0));
    Fr g2 = fr_add(g1, fr_sub(g1, g0));
    acc[2] = fr_add(acc[2], fr_add(fr_mul(f2, fr_add(wb, w2)), fr_mul(g2, w2)));
  }
  block_reduce_store(acc, partials);
}

// ---------------------------------------------------------------- launchers
static inline unsigned blocks_for(long long n) {
  return (unsigned)((n + THREADS - 1) / THREADS);
}

extern "C" {

int gkr_mont_mul(const void* a, const void* b, void* out, long long n,
                 long long b_div, void* stream) {
  k_mont_mul<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, b_div);
  return (int)cudaGetLastError();
}

int gkr_fold(const void* S, const void* r, void* out, long long m, void* stream) {
  k_fold<<<blocks_for(m), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)S, (const uint32_t*)r, (uint32_t*)out, m);
  return (int)cudaGetLastError();
}

int gkr_phase1_partials(const void* S, void* partials, long long half,
                        int grid, void* stream) {
  k_phase1_partials<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)S, (uint32_t*)partials, half);
  return (int)cudaGetLastError();
}

int gkr_phase2_partials(const void* S, const void* wb, void* partials,
                        long long half, int grid, void* stream) {
  k_phase2_partials<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)S, (const uint32_t*)wb, (uint32_t*)partials, half);
  return (int)cudaGetLastError();
}

}  // extern "C"
