// The layer sumcheck's kernels for Hopper (sm_90a), bound to Python through a
// plain C interface (ctypes, gkr_tpu_torch.torcheng.kernels).
//
// Each launcher takes device pointers to int32 limb tensors (16 limbs of 16
// bits per field element, row-major, 64 bytes an element), enqueues on the
// given stream, allocates nothing, and returns cudaGetLastError().
//
//   gkr_mont_mul        a * b / R elementwise        pallas_kernels.pl_mont_mul_T
//   gkr_fold            lo + r * (hi - lo)           pallas_kernels.pl_fold
//   gkr_phase_eval      per-block sums of g(0,1,2)   pl_phase{1,2}_partials
//                       (k_eval<4>, k_eval<3>), or   pl_phase{1,2}_eval
//                       their sum in the same launch
//   gkr_eval_attrs      the evals' tile, block and residency
//   gkr_eq_table        the chi table of a point     pl_eq_table_T
//   gkr_seg_sum         per-bucket sums, key-sorted  pl_seg_sum_T
//   gkr_normalize       relaxed -> canonical (x s)   pl_normalize_T / pl_normalize_mul_T
//   gkr_round_tail      partials -> (c2, c1, c0) and the round's challenge
//                                                    pl_round_coeffs + pl_mimc_multi
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

// ------------------------------------------------------------ round evals
// Replace pallas_kernels.pl_phase1_partials / pl_phase2_partials and, with
// their sum in the same launch, pl_phase1_eval / pl_phase2_eval.  One kernel
// template for both phases (T = 4: [W, HA1, HA2, HM]; T = 3: [W, FA,
// FMwb]).  A round's sum at t = 0, 1, 2 is, in both phases,
//   y_t = sum_s u_t(s) W_t(s) + c * sum_s l_t(s),   X_0 = lo, X_1 = hi,
//   X_2 = 2 hi - lo,
// with u = HA1 + HM, l = HA2, c = 1 in phase 1 and u = FA + FMwb, l = FA,
// c = wb in phase 2: FA (wb + W) + FMwb W = W (FA + FMwb) + wb FA, so phase 2
// takes three products an entry (the JAX formula, kept by the plain
// version, takes six) and one by wb a block and t.  The linear sums are
// taken at lo and hi only: sum l_2 = 2 sum l_1 - sum l_0.
//
// What bounds it: the bytes (80 us at n = 2^20 in phase 1, 60 us in phase
// 2), but a Montgomery product issues far slower than its IMAD count, and
// at the occupancy shared memory leaves, the 3 n/2 products alone take
// about as long as the loads (each timed alone by a build that skipped the
// other), so the design keeps both streams full and overlapped.
//
// Tiles: entries [k TILE, (k+1) TILE) of lo and the same range of hi are
// tile k, two contiguous byte ranges; block b walks tiles b, b + G, ... (a
// persistent grid of one block an SM).  A ring of EVAL_STAGES tiles in
// dynamic shared memory is filled by 16-byte cp.async copies (coalesced:
// neighbouring threads copy neighbouring 16 bytes), two tiles in flight
// while the block computes on the third, one barrier a tile; each entry
// sits at a pitch of its size plus 16 bytes, so the 16-byte reads of
// neighbouring entries hit 8 distinct bank groups.  Three threads share an
// entry, one point t each (warp-uniform), and read its limbs from shared
// memory as they need them: one product a thread a tile, on 12 warps an SM
// (one thread an entry, on 6 warps, ran slower: the products bind).  W_2
// enters its product unreduced (below 3p, fr_twice_minus), which shortens
// the t = 2 thread, the longest.
//
// Sums are lazy: every canonical product and linear term is added into a
// 9-word accumulator (value < 2^288, so no carry is lost below 2^34 terms;
// tests/test_torch_eval.py models each bound), folded by warp shuffles and
// then across warps, and reduced mod p once a block and accumulator (REDC,
// then one product, by R^2 or, for the linear sums, by c R^2).  Each block
// writes its canonical (3, 16) partial.  With `out` given (the per-round
// engine's eval), the last block to finish (a ticket counter, incremented
// after a __threadfence) sums the G partials as round_tail does and writes
// y (3, 16); it then resets the counter to 0.
#define EVAL_TILE 128            // entries of a tile
#define EVAL_THREADS (3 * EVAL_TILE)  // one thread a point t of an entry
#define EVAL_STAGES 3            // tiles in the ring: two in flight, one computed
#define TAIL_WORDS 48            // (3, 16) limbs of one partial
#define TAIL_MAX_G 1024          // partials a round_tail takes at most

struct Acc9 {
  uint32_t w[9];
};

__device__ __forceinline__ void acc9_zero(Acc9& a) {
#pragma unroll
  for (int j = 0; j < 9; ++j) a.w[j] = 0u;
}

// a += b (9 words), one carry chain; the sums it takes stay below 2^288.
__device__ __forceinline__ void acc9_add(Acc9& a, const Acc9& b) {
  asm("add.cc.u32 %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %11;\n\t"
      "addc.cc.u32 %3, %3, %12;\n\t"
      "addc.cc.u32 %4, %4, %13;\n\t"
      "addc.cc.u32 %5, %5, %14;\n\t"
      "addc.cc.u32 %6, %6, %15;\n\t"
      "addc.cc.u32 %7, %7, %16;\n\t"
      "addc.u32 %8, %8, %17;"
      : "+r"(a.w[0]), "+r"(a.w[1]), "+r"(a.w[2]), "+r"(a.w[3]), "+r"(a.w[4]),
        "+r"(a.w[5]), "+r"(a.w[6]), "+r"(a.w[7]), "+r"(a.w[8])
      : "r"(b.w[0]), "r"(b.w[1]), "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]),
        "r"(b.w[5]), "r"(b.w[6]), "r"(b.w[7]), "r"(b.w[8]));
}

// a += x, a canonical element.
__device__ __forceinline__ void acc9_add(Acc9& a, const Fr& x) {
  Acc9 b;
#pragma unroll
  for (int j = 0; j < 8; ++j) b.w[j] = x.w[j];
  b.w[8] = 0u;
  acc9_add(a, b);
}

// A lazy sum a (value < 2^288 < p 2^256) -> a / R mod p, canonical (REDC);
// a mod p is one product by R^2 more.
__device__ __forceinline__ Fr acc9_redc(const Acc9& a) {
  uint32_t T[17];
#pragma unroll
  for (int j = 0; j < 9; ++j) T[j] = a.w[j];
#pragma unroll
  for (int j = 9; j < 17; ++j) T[j] = 0u;
  return fr_redc_wide(T);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The cross-block sum of G <= TAIL_MAX_G canonical (3, 16) partials into
// y[0..2] (shared), called by every thread of an NT-thread block.  Lazy:
// each 16-bit limb is added as it is into a 32-bit accumulator
// (G * (2^16 - 1) < 2^26), the threads fold theirs by warp shuffles and then
// across warps, and threads 0..2 each turn one y_t's relaxed limbs (value
// < 1024 p) into words and reduce them mod p (REDC, then x R^2, as
// k_normalize).  The partials are read through L2 (__ldcg): in a one-launch
// eval other blocks of the grid wrote them.
template <int NT>
__device__ void sum_partials(const uint32_t* partials, int G, Fr* y) {
  __shared__ uint32_t red[NT / 32][TAIL_WORDS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint32_t acc[TAIL_WORDS];
#pragma unroll
  for (int l = 0; l < TAIL_WORDS; ++l) acc[l] = 0u;
  for (int g = tid; g < G; g += NT) {
    const uint4* q = reinterpret_cast<const uint4*>(partials + TAIL_WORDS * g);
#pragma unroll
    for (int k = 0; k < TAIL_WORDS / 4; ++k) {
      const uint4 v = __ldcg(q + k);
      acc[4 * k] += v.x;
      acc[4 * k + 1] += v.y;
      acc[4 * k + 2] += v.z;
      acc[4 * k + 3] += v.w;
    }
  }
#pragma unroll
  for (int l = 0; l < TAIL_WORDS; ++l) {
    uint32_t v = acc[l];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][l] = v;
  }
  __syncthreads();
  if (tid < 3) {
    uint32_t T[17];
    uint32_t c = 0u;
#pragma unroll
    for (int l = 0; l < 16; ++l) {
      uint32_t s = c;
#pragma unroll
      for (int w = 0; w < NT / 32; ++w) s += red[w][16 * tid + l];
      const uint32_t limb = s & 0xffffu;
      c = s >> 16;
      if (l & 1) T[l >> 1] |= limb << 16;
      else T[l >> 1] = limb;
    }
    T[8] = c;
#pragma unroll
    for (int j = 9; j < 17; ++j) T[j] = 0u;
    y[tid] = fr_mul(fr_redc_wide(T), fr_const(FR_R2));
  }
  __syncthreads();
}

template <int T>
struct EvalLayout {
  static constexpr int UNITS = 4 * T;                 // 16-byte units of an entry
  static constexpr int PITCH = UNITS + 1;             // odd: conflict-free reads
  static constexpr int HALF = EVAL_TILE * PITCH;      // lo (or hi) of a stage
  static constexpr int STAGE = 2 * HALF;
  static constexpr int SMEM = EVAL_STAGES * STAGE * 16;   // bytes
  static constexpr int U_A = 1, U_B = T - 1;          // u = X[U_A] + X[U_B]
  static constexpr int LIN = T == 4 ? 2 : 1;          // l = X[LIN]
};

// Copies tile k (if there is one) into ring stage `dst`; one commit group.
template <int T>
__device__ __forceinline__ void eval_issue(uint4* dst, const uint4* src,
                                           long long k, long long n_tiles,
                                           long long half) {
  using Lay = EvalLayout<T>;
  if (k < n_tiles) {
    const long long e0 = k * EVAL_TILE;
    const int m = (int)min((long long)EVAL_TILE, half - e0);
    const uint4* lo = src + e0 * Lay::UNITS;
    const uint4* hi = src + (half + e0) * Lay::UNITS;
    for (int q = threadIdx.x; q < m * Lay::UNITS; q += EVAL_THREADS) {
      const int e = q / Lay::UNITS, c = q - e * Lay::UNITS;
      cp_async16(dst + e * Lay::PITCH + c, lo + q);
      cp_async16(dst + Lay::HALF + e * Lay::PITCH + c, hi + q);
    }
  }
  cp_async_commit();
}

// One point t of one entry: v += u_t W_t, and l += l_t at t = 0, 1.
template <int T>
__device__ __forceinline__ void eval_point(int t, const uint32_t* lo,
                                           const uint32_t* hi, Acc9& v, Acc9& l) {
  using Lay = EvalLayout<T>;
  if (t < 2) {
    const uint32_t* x = t ? hi : lo;
    const Fr u = fr_add(fr_load(x + 16 * Lay::U_A), fr_load(x + 16 * Lay::U_B));
    acc9_add(v, fr_mul(u, fr_load(x)));
    acc9_add(l, fr_load(x + 16 * Lay::LIN));
  } else {
    const Fr u0 = fr_add(fr_load(lo + 16 * Lay::U_A), fr_load(lo + 16 * Lay::U_B));
    const Fr u1 = fr_add(fr_load(hi + 16 * Lay::U_A), fr_load(hi + 16 * Lay::U_B));
    const Fr w2 = fr_twice_minus(fr_load(hi), fr_load(lo));
    acc9_add(v, fr_mul(w2, fr_add(u1, fr_sub(u1, u0))));
  }
}

// S: (n, T, 16), half = n/2; wbp: phase 2's wb (null in phase 1);
// partials: (gridDim.x, 3, 16); out, ticket: the one-launch eval (or null).
// Thread tid takes point t = tid / EVAL_TILE (one t a warp) of entry
// tid % EVAL_TILE of each tile.
template <int T>
__global__ void __launch_bounds__(EVAL_THREADS, 1)
k_eval(const uint32_t* __restrict__ S, const uint32_t* __restrict__ wbp,
       uint32_t* partials, long long half, unsigned* ticket,
       uint32_t* __restrict__ out) {
  using Lay = EvalLayout<T>;
  constexpr int WARPS_T = EVAL_TILE / 32;             // warps of one point t
  extern __shared__ uint4 ring[];
  __shared__ Acc9 red[EVAL_THREADS / 32][2];
  __shared__ Fr ys[5], z;
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = tid / EVAL_TILE, e = tid - t * EVAL_TILE;
  const long long G = gridDim.x;
  const long long n_tiles = (half + EVAL_TILE - 1) / EVAL_TILE;
  const uint4* src = reinterpret_cast<const uint4*>(S);

  Acc9 v, l;
  acc9_zero(v);
  acc9_zero(l);
  // tiles k and k + G are in flight while the block computes on k - G; the
  // one barrier a tile also frees the stage that tile k + 2G then takes
#pragma unroll
  for (int j = 0; j < EVAL_STAGES - 1; ++j)
    eval_issue<T>(ring + j * Lay::STAGE, src, blockIdx.x + j * G, n_tiles, half);
  int stage = 0;
  for (long long k = blockIdx.x; k < n_tiles; k += G) {
    cp_async_wait<EVAL_STAGES - 2>();
    __syncthreads();
    const int refill = stage == 0 ? EVAL_STAGES - 1 : stage - 1;
    eval_issue<T>(ring + refill * Lay::STAGE, src, k + (EVAL_STAGES - 1) * G, n_tiles, half);
    if (k * EVAL_TILE + e < half) {
      const uint32_t* lo =
          reinterpret_cast<const uint32_t*>(ring + stage * Lay::STAGE + e * Lay::PITCH);
      eval_point<T>(t, lo, lo + 4 * Lay::HALF, v, l);
    }
    stage = stage + 1 == EVAL_STAGES ? 0 : stage + 1;
  }
  cp_async_wait<0>();

  // the block's sums: warp shuffles, then the warps of each point, one
  // reduction each of V_0, V_1, V_2, L_0, L_1
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Acc9 ov, ol;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      ov.w[j] = __shfl_down_sync(0xffffffffu, v.w[j], off);
      ol.w[j] = __shfl_down_sync(0xffffffffu, l.w[j], off);
    }
    acc9_add(v, ov);
    acc9_add(l, ol);
  }
  if (lane == 0) {
    red[warp][0] = v;
    red[warp][1] = l;
  }
  __syncthreads();
  // ys: V_t mod p, and L_0, L_1 left as REDC gives them (L / R); z = R^2,
  // or wb R^2 in phase 2, so that c L_t = fr_mul(L_t / R, z): every thread
  // of the tail takes at most two dependent products
  if (tid < 5) {
    const int g = tid < 3 ? tid : tid - 3, which = tid < 3 ? 0 : 1;
    Acc9 s = red[g * WARPS_T][which];
#pragma unroll
    for (int w = 1; w < WARPS_T; ++w) acc9_add(s, red[g * WARPS_T + w][which]);
    const Fr r = acc9_redc(s);
    ys[tid] = tid < 3 ? fr_mul(r, fr_const(FR_R2)) : r;
  } else if (tid == 5) {
    z = wbp ? fr_mul(fr_load(wbp), fr_const(FR_R2)) : fr_const(FR_R2);
  }
  __syncthreads();
  if (tid < 3) {
    const Fr l = tid < 2 ? ys[3 + tid] : fr_add(ys[4], fr_sub(ys[4], ys[3]));
    fr_store(partials + 48 * blockIdx.x + 16 * tid, fr_add(ys[tid], fr_mul(l, z)));
    if (out) __threadfence();
  }
  if (!out) return;
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1u) == (unsigned)(G - 1);
  __syncthreads();
  if (!last) return;
  sum_partials<EVAL_THREADS>(partials, (int)G, ys);
  if (tid < 3) fr_store(out + 16 * tid, ys[tid]);
  if (tid == 0) *ticket = 0u;
}

// ------------------------------------------------------------- eq table
// Replaces pallas_kernels.pl_eq_table_T (its doubling _eq_extend_T): the chi
// table out[b] = prod_j (bit j of b ? z_j : 1 - z_j) of a point z (k, 16),
// MSB-first (z_0 is the top index bit), 2^k entries, in one launch.
//
// What bounds it: the table, written once (2^k x 64 B: 20 us at k = 20), and
// one product an entry (2^20 products: 11 us of IMADs at the card's peak, but
// a product issues at ~1.8x its IMAD count, so the products bind).  The
// doubling it replaces took a launch a variable and two products an entry
// pair at every level, and read and rewrote the table at each.
//
// The design: the variables are cut MSB-first into n = ceil(k / EQ_BITS)
// factor tables of at most EQ_BITS variables, one entry a lane: T_{n-1} over
// the last min(k, EQ_BITS), T_1 .. T_{n-2} over EQ_BITS each above it, T_0
// over the rest at the top.  Entry b = (i_0, ..., i_{n-1}) is the product
// T_0[i_0] ... T_{n-1}[i_{n-1}]; row r = b >> EQ_BITS has the value
// V[r] = T_0[i_0] ... T_{n-2}[i_{n-2}], and out[(r << EQ_BITS) | l] =
// V[r] T_{n-1}[l]: one product an entry.  A persistent grid (at most the
// blocks the card holds at once) builds the tables once a block in shared
// memory (warp t, lane i: T_t[i], its factors loaded at once and multiplied
// as a tree, three products deep); each lane keeps T_{n-1}[lane] in
// registers.  Block g writes a contiguous share of the rows, EQ_BATCH rows
// at a time: every thread takes the values of up to two of them (n - 2
// products each), then warp w writes rows w, w + EQ_WARPS, ... of the batch
// (lane l: one product and four 16-byte stores, so a warp writes a
// contiguous 2 KB row); two barriers a batch, one batch a block at k = 20.
// Every product is canonical, so the order of the products changes no limb:
// the table is bit-equal to the doubling.
#define EQ_BITS 5                         // variables of a factor table
#define EQ_WIDTH (1 << EQ_BITS)           // its entries, one a lane
#define EQ_MAX_K 32                       // variables a table takes at most
#define EQ_MAX_TABLES ((EQ_MAX_K + EQ_BITS - 1) / EQ_BITS)
#define EQ_THREADS 512
#define EQ_WARPS (EQ_THREADS / 32)
#define EQ_BATCH (2 * EQ_THREADS)         // rows whose values a block holds

// z_j for index bit 1, 1 - z_j for 0
__device__ __forceinline__ Fr eq_factor(const uint32_t* zj, int bit) {
  const Fr x = fr_load(zj);
  return bit ? x : fr_sub(fr_const(FR_ONE), x);
}

// V[r] = T_0[i_0] ... T_{n-2}[i_{n-2}] (1 for one table), i_{n-2} the low
// EQ_BITS bits of r
__device__ __forceinline__ Fr eq_row_value(const Fr* tab, int n, long long r) {
  if (n == 1) return fr_const(FR_ONE);
  Fr x = tab[r >> (EQ_BITS * (n - 2))];
  for (int t = 1; t < n - 1; ++t)
    x = fr_mul(x, tab[EQ_WIDTH * t + ((r >> (EQ_BITS * (n - 2 - t))) & (EQ_WIDTH - 1))]);
  return x;
}

__global__ void __launch_bounds__(EQ_THREADS, 1)
k_eq_table(const uint32_t* __restrict__ z, int k, uint32_t* __restrict__ out) {
  __shared__ Fr tab[EQ_MAX_TABLES * EQ_WIDTH];     // T_t[i] at EQ_WIDTH t + i
  __shared__ Fr vals[EQ_BATCH];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = (k + EQ_BITS - 1) / EQ_BITS;
  const int w0 = k - EQ_BITS * (n - 1);          // variables of T_0
  const int kl = n == 1 ? k : EQ_BITS;           // variables of T_{n-1}
  if (warp < n) {
    // T_t over z_v .. z_{v+w-1}, z_v its top index bit; factors past w are 1
    const int w = warp ? EQ_BITS : w0;
    const int v = warp ? w0 + EQ_BITS * (warp - 1) : 0;
    Fr f[EQ_BITS];
#pragma unroll
    for (int q = 0; q < EQ_BITS; ++q)
      f[q] = q < w ? eq_factor(z + 16 * (v + q), (lane >> (w - 1 - q)) & 1)
                   : fr_const(FR_ONE);
    tab[EQ_WIDTH * warp + lane] =
        fr_mul(fr_mul(fr_mul(f[0], f[1]), fr_mul(f[2], f[3])), f[4]);
  }
  __syncthreads();
  const bool writes = lane < (1 << kl);
  const Fr tl = writes ? tab[EQ_WIDTH * (n - 1) + lane] : fr_zero();
  const long long rows = 1LL << (k - kl);
  const long long r0 = rows * blockIdx.x / gridDim.x;
  const long long r1 = rows * (blockIdx.x + 1) / gridDim.x;
  for (long long rb = r0; rb < r1; rb += EQ_BATCH) {
    const int m = (int)(r1 - rb < EQ_BATCH ? r1 - rb : EQ_BATCH);
    for (int j = tid; j < m; j += EQ_THREADS) vals[j] = eq_row_value(tab, n, rb + j);
    __syncthreads();
#pragma unroll 1
    for (int j = warp; j < m; j += EQ_WARPS) {
      const Fr y = fr_mul(vals[j], tl);
      if (writes) fr_store(out + 16 * (((rb + j) << kl) | lane), y);
    }
    __syncthreads();
  }
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
// out[i] = value mod p in Montgomery form: REDC (value / R), then x R^2 / R;
// with a scalar s, x (s R) / R instead (one product an entry fewer), s R =
// fr_mul(s, R^2) taken once a block by its first thread while the others
// reduce their first entries, on a grid of the blocks the card holds at
// once, each thread's next entry reduced before its product of this one.
// The carry chain turns the relaxed limbs into 16 32-bit words (value <
// 2^510, so nothing spills past them).
__device__ __forceinline__ Fr normalize_redc(const uint32_t* __restrict__ t,
                                             int lin, long long n, long long i) {
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
  return fr_redc_wide(T);
}

template <bool SCALED>
__global__ void __launch_bounds__(THREADS)
k_normalize(const uint32_t* __restrict__ t, int lin,
            const uint32_t* __restrict__ sp, uint32_t* __restrict__ out,
            long long n) {
  long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if constexpr (!SCALED) {
    if (i >= n) return;
    fr_store(out + 16 * i, fr_mul(normalize_redc(t, lin, n, i), fr_const(FR_R2)));
  } else {
    __shared__ Fr sr;
    if (threadIdx.x == 0) sr = fr_mul(fr_load(sp), fr_const(FR_R2));
    Fr x = i < n ? normalize_redc(t, lin, n, i) : fr_zero();
    __syncthreads();
    const Fr s1 = sr;
    const long long stride = (long long)gridDim.x * THREADS;
    while (i < n) {
      const long long next = i + stride;
      const Fr xn = next < n ? normalize_redc(t, lin, n, next) : x;
      fr_store(out + 16 * i, fr_mul(x, s1));
      x = xn;
      i = next;
    }
  }
}

// -------------------------------------------------------------------- MiMC
// multi_hash(x[0..len), key 0) of MiMC7 with n_rounds rounds (iden3):
// hash(x, k): h = (x + k)^7, then h = (h + k + c_i)^7 for i >= 1, return
// h + k;  r = 0; for x: r = r + x + hash(x, r).  With c_0 = 0 and the key
// table kc_i = (k + c_i) mod p, every round is h = (h + kc_i)^7 from h = x.
//
// The rounds are one dependent chain, run by one thread: 3 dependent
// products a round (fr_pow7) of the latency-first fr_mul_lat, on the 29-bit
// limbs of Fr29 (fr.cuh), where no value is reduced inside the chain and
// h + kc_i is a limb-wise add.  kc lives in shared memory, filled by the
// block's threads before each element, so the chain never waits on device
// memory; the next round's key is read while this round's products run.
#define MIMC_MAX_ROUNDS 91

__device__ __forceinline__ Fr mimc_rounds(const Fr& x, const Fr29* kc,
                                          int n_rounds) {
  Fr29 h = fr29_from_fr(x);
  Fr29 k = kc[0];
  for (int i = 0; i < n_rounds; ++i) {
    const Fr29 t = fr29_add_lazy(h, k);
    if (i + 1 < n_rounds) k = kc[i + 1];
    h = fr_pow7(t);
  }
  return fr29_to_fr(h);
}

// Called by every thread of the block.  x: len elements of 16 limbs, read
// by thread 0 only; kc (n_rounds entries) and r_sh in shared memory.
// Returns r in every thread.
__device__ Fr mimc_multi_block(const uint32_t* x, int len,
                               const uint32_t* __restrict__ cts, int n_rounds,
                               Fr29* kc, Fr* r_sh) {
  Fr r = fr_zero();
  for (int e = 0; e < len; ++e) {
    for (int i = threadIdx.x; i < n_rounds; i += blockDim.x)
      kc[i] = fr29_from_fr(fr_add(r, fr_load(cts + 16 * i)));
    __syncthreads();
    if (threadIdx.x == 0) {
      const Fr xe = fr_load(x + 16 * e);
      const Fr h = mimc_rounds(xe, kc, n_rounds);
      *r_sh = fr_add(fr_add(r, xe), fr_add(h, r));
    }
    __syncthreads();
    r = *r_sh;
  }
  return r;
}

// One warp: lane 0 runs the chain, the others fill the key table.
#define MIMC_THREADS 32

__global__ void __launch_bounds__(MIMC_THREADS)
k_mimc_multi(const uint32_t* __restrict__ x, int len,
             const uint32_t* __restrict__ cts, int n_rounds,
             uint32_t* __restrict__ out) {
  __shared__ Fr29 kc[MIMC_MAX_ROUNDS];
  __shared__ Fr r_sh;
  const Fr r = mimc_multi_block(x, len, cts, n_rounds, kc, &r_sh);
  if (threadIdx.x == 0) fr_store(out, r);
}

// --------------------------------------------------------------- round tail
// The end of a fused round in one launch: partials -> coefficients -> the
// round's challenge.  partials: G <= 1024 canonical (3, 16) block sums of
// g(0), g(1), g(2), summed lazily (sum_partials).  Thread 0 interpolates c2 =
// (y2 + y0 - 2 y1) / 2, c1 = y1 - y0 - c2, c0 = y0, writes coeffs (3, 16) =
// (c2, c1, c0), and the block hashes coeffs[3 - length:] (mimc_multi_block)
// into r (16,).
#define TAIL_THREADS 256

__global__ void __launch_bounds__(TAIL_THREADS)
k_round_tail(const uint32_t* __restrict__ partials, int G, int length,
             const uint32_t* __restrict__ cts, int n_rounds,
             uint32_t* coeffs, uint32_t* __restrict__ r_out) {
  __shared__ Fr y[3];
  __shared__ Fr29 kc[MIMC_MAX_ROUNDS];
  __shared__ Fr r_sh;
  const int tid = threadIdx.x;
  sum_partials<TAIL_THREADS>(partials, G, y);
  if (tid == 0) {
    const Fr y0 = y[0], y1 = y[1], y2 = y[2];
    const Fr c2 = fr_half(fr_sub(fr_add(y2, y0), fr_add(y1, y1)));
    fr_store(coeffs, c2);
    fr_store(coeffs + 16, fr_sub(fr_sub(y1, y0), c2));
    fr_store(coeffs + 32, y0);
  }
  // thread 0 reads back what it wrote: no other thread reads coeffs
  const Fr r = mimc_multi_block(coeffs + 16 * (3 - length), length, cts,
                                n_rounds, kc, &r_sh);
  if (tid == 0) fr_store(r_out, r);
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

// The blocks of `threads` threads of `kernel` that the card holds at once
// (SMs x resident blocks an SM), queried once a device into `cache`.
template <typename Kernel>
static cudaError_t resident_blocks(Kernel kernel, int threads, int (&cache)[64],
                                   long long* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev < 64 && cache[dev]) {
    *blocks = cache[dev];
    return e;
  }
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
  if (e != cudaSuccess) {
    cudaGetLastError();       // not left behind for the next launch's check
    return e;
  }
  *blocks = (long long)sms * per_sm;
  if (dev < 64) cache[dev] = sms * per_sm;
  return e;
}

// Above 48 KB a block's dynamic shared memory must be allowed per kernel,
// once for each device.
template <int T>
static cudaError_t eval_attr() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && done[dev])) return e;
  e = cudaFuncSetAttribute(k_eval<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           EvalLayout<T>::SMEM);
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
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

// tables 4: phase 1 (wb null), 3: phase 2.  With out and ticket null the
// launch leaves the grid's partials; with both given it also writes the sum
// y (3, 16), and ticket (one unsigned, 0 before the launch) is 0 after it.
int gkr_phase_eval(int tables, const void* S, const void* wb, void* partials,
                   long long half, int grid, void* ticket, void* out,
                   void* stream) {
  if (half < 1 || grid < 1 || grid > TAIL_MAX_G || (tables == 4) != (wb == nullptr) ||
      (tables != 3 && tables != 4) || (ticket == nullptr) != (out == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = tables == 4 ? eval_attr<4>() : eval_attr<3>();
  if (e != cudaSuccess) {
    cudaGetLastError();       // not left behind for the next launch's check
    return (int)e;
  }
  auto kernel = tables == 4 ? k_eval<4> : k_eval<3>;
  const int smem = tables == 4 ? EvalLayout<4>::SMEM : EvalLayout<3>::SMEM;
  kernel<<<grid, EVAL_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)S, (const uint32_t*)wb, (uint32_t*)partials, half,
      (unsigned*)ticket, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// The eval kernel of `tables` as it runs: attrs[0] entries a tile, attrs[1]
// threads a block, attrs[2] dynamic shared memory in bytes, attrs[3]
// resident blocks an SM at that shared memory.  Registers and spills are
// ptxas's to report.
int gkr_eval_attrs(int tables, void* attrs) {
  if (tables != 3 && tables != 4) return (int)cudaErrorInvalidValue;
  int* a = (int*)attrs;
  a[0] = EVAL_TILE;
  a[1] = EVAL_THREADS;
  a[2] = tables == 4 ? EvalLayout<4>::SMEM : EvalLayout<3>::SMEM;
  cudaError_t e = tables == 4 ? eval_attr<4>() : eval_attr<3>();
  if (e == cudaSuccess)
    e = tables == 4
            ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&a[3], k_eval<4>, a[1], a[2])
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&a[3], k_eval<3>, a[1], a[2]);
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

// The chi table of z (k, 16), 1 <= k <= EQ_MAX_K, into out (2^k, 16), on
// at most the blocks the card holds at once and at most one a row.
int gkr_eq_table(const void* z, int k, void* out, void* stream) {
  if (k < 1 || k > EQ_MAX_K) return (int)cudaErrorInvalidValue;
  static int cache[64] = {};
  long long blocks = 0;
  const cudaError_t e = resident_blocks(k_eq_table, EQ_THREADS, cache, &blocks);
  if (e != cudaSuccess) return (int)e;
  const long long rows = 1LL << (k - (k < EQ_BITS ? k : EQ_BITS));
  k_eq_table<<<(unsigned)(rows < blocks ? rows : blocks), EQ_THREADS, 0,
               (cudaStream_t)stream>>>((const uint32_t*)z, k, (uint32_t*)out);
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
  if (!s) {
    k_normalize<false><<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)t, lin, nullptr, (uint32_t*)out, n);
    return (int)cudaGetLastError();
  }
  static int cache[64] = {};
  long long blocks = 0;
  const cudaError_t e = resident_blocks(k_normalize<true>, THREADS, cache, &blocks);
  if (e != cudaSuccess) return (int)e;
  k_normalize<true><<<(unsigned)(blocks_for(n) < blocks ? blocks_for(n) : blocks),
                      THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)t, lin, (const uint32_t*)s, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

int gkr_round_tail(const void* partials, int G, int length, const void* cts,
                   int n_rounds, void* coeffs, void* r, void* stream) {
  if (G < 1 || G > TAIL_MAX_G || length < 1 || length > 3 || n_rounds < 1 ||
      n_rounds > MIMC_MAX_ROUNDS)
    return (int)cudaErrorInvalidValue;
  k_round_tail<<<1, TAIL_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)partials, G, length, (const uint32_t*)cts, n_rounds,
      (uint32_t*)coeffs, (uint32_t*)r);
  return (int)cudaGetLastError();
}

int gkr_mimc_multi(const void* x, int len, const void* cts, int n_rounds,
                   void* out, void* stream) {
  if (len < 1 || n_rounds < 1 || n_rounds > MIMC_MAX_ROUNDS)
    return (int)cudaErrorInvalidValue;
  k_mimc_multi<<<1, MIMC_THREADS, 0, (cudaStream_t)stream>>>(
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
