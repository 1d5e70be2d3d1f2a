// The layer sumcheck's kernels for Hopper (sm_90a), bound to Python through a
// plain C interface (ctypes, gkr_tpu_torch.torcheng.kernels).
//
// Each launcher takes device pointers to int32 limb tensors (16 limbs of 16
// bits per field element, row-major, 64 bytes an element), enqueues on the
// given stream, allocates nothing, and returns cudaGetLastError().
//
//   gkr_mont_mul        a * b / R elementwise        pallas_kernels.pl_mont_mul_T
//   gkr_fold            lo + r * (hi - lo)           pallas_kernels.pl_fold
//   gkr_phase1_partials per-block sums of g(0,1,2)   pl_phase1_eval / pl_phase1_partials
//   gkr_phase2_partials per-block sums of g(0,1,2)   pl_phase2_eval / pl_phase2_partials
//   gkr_eq_double       one doubling of the chi table  pl_eq_table_T
//   gkr_seg_sum         per-bucket sums, key-sorted  pl_seg_sum_T
//   gkr_normalize       relaxed -> canonical (x s)   pl_normalize_T / pl_normalize_mul_T
//   gkr_round_coeffs    partials -> (c2, c1, c0)     pl_round_coeffs
//   gkr_mimc_multi      MiMC7 multi_hash, key 0      pl_mimc_multi
//   gkr_stack           T (n, 16) tables -> (n, T, 16)  pl_transpose_T
//
// Stacked tables keep the JAX per-round engine's (n, T, 16) layout: entry s
// of table t is element s*T + t, and the MSB variable splits the table axis
// into lo = entries [0, n/2) and hi = entries [n/2, n).  Relaxed segment sums
// are limb-major, (18, n), as pl_normalize_T reads them.
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
// Folds the block's per-thread canonical sums by a tree of field adds in
// shared memory; the block's total lands in sh[t][0].
__device__ __forceinline__ void block_reduce3(Fr acc[3], Fr (*sh)[THREADS]) {
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
}

// Each block writes one (3, 16) canonical partial.
__device__ __forceinline__ void block_reduce_store(Fr acc[3],
                                                   uint32_t* partials) {
  __shared__ Fr sh[3][THREADS];
  block_reduce3(acc, sh);
  if (threadIdx.x == 0) {
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

// ------------------------------------------------------------- eq table
// One MSB-first doubling in place: t[i], i < m  ->  t[i] = t[i] * (1 - z),
// t[i + m] = t[i] * z.  A thread reads only its own entry before writing it,
// and entries [m, 2m) are read by no one, so one buffer serves every step.
__global__ void __launch_bounds__(THREADS)
k_eq_double(uint32_t* __restrict__ t, const uint32_t* __restrict__ zp,
            long long m) {
  long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= m) return;
  Fr z = fr_load(zp);
  Fr zc = fr_sub(fr_const(FR_ONE), z);
  Fr x = fr_load(t + 16 * i);
  fr_store(t + 16 * (i + m), fr_mul(x, z));
  fr_store(t + 16 * i, fr_mul(x, zc));
}

// ------------------------------------------------------------ segment sum
// out[t][l][b] = limb l of sum_{g: key_g == b} w_t[g], for gates sorted by
// key: bucket b holds gates [hib[b-1], hib[b]).  The exact integer sum is
// written as 18 clean 16-bit limbs (value < 2^30 p < 2^288), limb-major.
// A thread sums its own bucket when it holds at most SEG_HOT gates; larger
// buckets are summed by the whole block, 64-bit per limb, one after another,
// so a skewed wiring neither serialises on one thread nor overflows.
#define SEG_LIMBS 18
#define SEG_HOT 32

__device__ __forceinline__ void seg_store(uint32_t* out, long long n,
                                          long long b,
                                          const unsigned long long acc[16]) {
  unsigned long long c = 0ull;
#pragma unroll
  for (int l = 0; l < 16; ++l) {
    unsigned long long s = acc[l] + c;
    out[l * n + b] = (uint32_t)(s & 0xffffull);
    c = s >> 16;
  }
  out[16 * n + b] = (uint32_t)(c & 0xffffull);
  out[17 * n + b] = (uint32_t)(c >> 16);
}

__device__ __forceinline__ void seg_add(unsigned long long acc[16],
                                        const uint32_t* w) {
  const uint4* q = reinterpret_cast<const uint4*>(w);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint4 v = q[k];
    acc[4 * k] += v.x;
    acc[4 * k + 1] += v.y;
    acc[4 * k + 2] += v.z;
    acc[4 * k + 3] += v.w;
  }
}

__global__ void __launch_bounds__(THREADS)
k_seg_sum(const int* __restrict__ hib, const uint32_t* __restrict__ w0,
          const uint32_t* __restrict__ w1, uint32_t* __restrict__ out,
          long long n, int T) {
  __shared__ int hot[THREADS];
  __shared__ int n_hot;
  __shared__ unsigned long long red[THREADS / 32][16];
  const int tid = threadIdx.x;
  const long long b0 = (long long)blockIdx.x * THREADS;
  const long long b = b0 + tid;
  if (tid == 0) n_hot = 0;
  __syncthreads();
  if (b < n) {
    long long lo = b ? hib[b - 1] : 0, hi = hib[b];
    if (hi - lo > SEG_HOT) {
      hot[atomicAdd(&n_hot, 1)] = tid;
    } else {
      for (int t = 0; t < T; ++t) {
        const uint32_t* w = t ? w1 : w0;
        unsigned long long acc[16];
#pragma unroll
        for (int l = 0; l < 16; ++l) acc[l] = 0ull;
        for (long long g = lo; g < hi; ++g) seg_add(acc, w + 16 * g);
        seg_store(out + (long long)t * SEG_LIMBS * n, n, b, acc);
      }
    }
  }
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5;
  for (int h = 0; h < n_hot; ++h) {
    const long long bb = b0 + hot[h];
    const long long lo = bb ? hib[bb - 1] : 0, hi = hib[bb];
    for (int t = 0; t < T; ++t) {
      const uint32_t* w = t ? w1 : w0;
      unsigned long long acc[16];
#pragma unroll
      for (int l = 0; l < 16; ++l) acc[l] = 0ull;
      for (long long g = lo + tid; g < hi; g += THREADS) seg_add(acc, w + 16 * g);
#pragma unroll
      for (int l = 0; l < 16; ++l) {
        unsigned long long v = acc[l];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) red[warp][l] = v;
      }
      __syncthreads();
      if (tid == 0) {
        unsigned long long tot[16];
#pragma unroll
        for (int l = 0; l < 16; ++l) {
          tot[l] = 0ull;
          for (int q = 0; q < THREADS / 32; ++q) tot[l] += red[q][l];
        }
        seg_store(out + (long long)t * SEG_LIMBS * n, n, bb, tot);
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------- normalize
// t: (lin, n) relaxed limbs, lin <= 32, each < 2^31, value < p * 2^256.
// out[i] = value mod p in Montgomery form: REDC (value / R), then x R^2 / R,
// then x s when a scalar s is given.  The carry chain turns the relaxed
// limbs into 16 32-bit words (value < 2^510, so nothing spills past them).
__global__ void __launch_bounds__(THREADS)
k_normalize(const uint32_t* __restrict__ t, int lin,
            const uint32_t* __restrict__ sp, uint32_t* __restrict__ out,
            long long n) {
  long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  uint32_t T[17];
  unsigned long long c = 0ull;
#pragma unroll
  for (int l = 0; l < 32; ++l) {
    unsigned long long s = c + (l < lin ? t[(long long)l * n + i] : 0u);
    uint32_t limb = (uint32_t)(s & 0xffffull);
    c = s >> 16;
    if (l & 1) T[l >> 1] |= limb << 16;
    else T[l >> 1] = limb;
  }
  T[16] = (uint32_t)c;
  Fr x = fr_mul(fr_redc_wide(T), fr_const(FR_R2));
  if (sp) x = fr_mul(x, fr_load(sp));
  fr_store(out + 16 * i, x);
}

// ------------------------------------------------------------ round coeffs
// partials: G canonical (3, 16) block sums of g(0), g(1), g(2).  One block
// adds them mod p and interpolates: c2 = (y2 + y0 - 2 y1) / 2,
// c1 = y1 - y0 - c2, c0 = y0; out is (3, 16) = (c2, c1, c0).
__global__ void __launch_bounds__(THREADS)
k_round_coeffs(const uint32_t* __restrict__ partials, int G,
               uint32_t* __restrict__ out) {
  __shared__ Fr sh[3][THREADS];
  Fr acc[3] = {fr_zero(), fr_zero(), fr_zero()};
  for (int g = threadIdx.x; g < G; g += THREADS) {
#pragma unroll
    for (int t = 0; t < 3; ++t) acc[t] = fr_add(acc[t], fr_load(partials + 48 * g + 16 * t));
  }
  block_reduce3(acc, sh);
  if (threadIdx.x == 0) {
    Fr y0 = sh[0][0], y1 = sh[1][0], y2 = sh[2][0];
    Fr c2 = fr_half(fr_sub(fr_add(y2, y0), fr_add(y1, y1)));
    Fr c1 = fr_sub(fr_sub(y1, y0), c2);
    fr_store(out, c2);
    fr_store(out + 16, c1);
    fr_store(out + 32, y0);
  }
}

// -------------------------------------------------------------------- MiMC
// multi_hash(x[0..len), key 0) of MiMC7 with n_rounds rounds (iden3):
// hash(x, k): h = (x + k)^7, then h = (h + k + c_i)^7 for i >= 1, return
// h + k;  r = 0; for x: r = r + x + hash(x, r).  cts: (n_rounds, 16)
// Montgomery constants.  One thread: every product depends on the last.
__global__ void k_mimc_multi(const uint32_t* __restrict__ x, int len,
                             const uint32_t* __restrict__ cts, int n_rounds,
                             uint32_t* __restrict__ out) {
  Fr r = fr_zero();
  for (int e = 0; e < len; ++e) {
    Fr xe = fr_load(x + 16 * e);
    Fr h = fr_pow7(fr_add(xe, r));
    for (int i = 1; i < n_rounds; ++i)
      h = fr_pow7(fr_add(fr_add(h, r), fr_load(cts + 16 * i)));
    r = fr_add(fr_add(r, xe), fr_add(h, r));
  }
  fr_store(out, r);
}

// ------------------------------------------------------------------- stack
// The phase builds' layout step: T <= 4 tables t_j (n, 16) into the
// (n, T, 16) stack the round kernels read, out[s][j] = t_j[s] -- the
// transpose of the (T, n) element axes.  One 16-byte vector a thread: the
// writes are contiguous and each table is read in runs of 64 bytes.  A null
// table is written as zeros.
__global__ void __launch_bounds__(THREADS)
k_stack(const uint4* __restrict__ t0, const uint4* __restrict__ t1,
        const uint4* __restrict__ t2, const uint4* __restrict__ t3, int T,
        uint4* __restrict__ out, long long n) {
  long long q = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (q >= n * T * 4) return;
  long long s = q / (4 * T);
  int j = (int)(q - s * 4 * T);
  const uint4* src = (j >> 2) == 0 ? t0 : (j >> 2) == 1 ? t1 : (j >> 2) == 2 ? t2 : t3;
  out[q] = src ? src[4 * s + (j & 3)] : make_uint4(0u, 0u, 0u, 0u);
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

int gkr_eq_double(void* t, const void* z, long long m, void* stream) {
  k_eq_double<<<blocks_for(m), THREADS, 0, (cudaStream_t)stream>>>(
      (uint32_t*)t, (const uint32_t*)z, m);
  return (int)cudaGetLastError();
}

int gkr_seg_sum(const void* hib, const void* w0, const void* w1, void* out,
                long long n, int T, void* stream) {
  k_seg_sum<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)hib, (const uint32_t*)w0, (const uint32_t*)w1,
      (uint32_t*)out, n, T);
  return (int)cudaGetLastError();
}

int gkr_normalize(const void* t, int lin, const void* s, void* out,
                  long long n, void* stream) {
  k_normalize<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)t, lin, (const uint32_t*)s, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

int gkr_round_coeffs(const void* partials, int G, void* out, void* stream) {
  k_round_coeffs<<<1, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)partials, G, (uint32_t*)out);
  return (int)cudaGetLastError();
}

int gkr_mimc_multi(const void* x, int len, const void* cts, int n_rounds,
                   void* out, void* stream) {
  k_mimc_multi<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, len, (const uint32_t*)cts, n_rounds, (uint32_t*)out);
  return (int)cudaGetLastError();
}

int gkr_stack(const void* t0, const void* t1, const void* t2, const void* t3,
              int T, void* out, long long n, void* stream) {
  k_stack<<<blocks_for(n * T * 4), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)t0, (const uint4*)t1, (const uint4*)t2, (const uint4*)t3,
      T, (uint4*)out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
