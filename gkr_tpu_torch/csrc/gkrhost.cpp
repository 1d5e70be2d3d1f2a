// gkrhost — native host runtime of gkr_tpu_torch, a copy of the JAX
// package's own (same ABI and results).
//
// The CUDA engine (torcheng/, csrc/kernels.cu) owns the large-table compute
// on the card; this library is the native counterpart of the reference's
// Rust prover core
// (rust/src/gkr/{poly,sumcheck}.rs + mimc-rs) for the HOST side: BN254 Fr
// arithmetic as 4x64-bit Montgomery limbs (__int128 products), MiMC7-91
// Fiat–Shamir, eq-table construction, wiring scatters, and the per-round
// sumcheck evaluate/fold kernels — OpenMP-parallel, playing the role of the
// reference's rayon par_iter (rust/src/gkr/sumcheck.rs:50-124).
//
// ABI: plain C functions over 32-byte little-endian canonical field
// representations ([u8;32], matching ff::PrimeField Repr — convert.rs:5).
// Bulk arrays are contiguous n x 32 bytes.  Values inside a batch call are
// converted to Montgomery domain internally where profitable.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC -std=c++17, at first
// use, by gkr_tpu_torch/native/__init__.py.

#include <cstdint>
#include <cstring>
#include <cstddef>

#ifdef _OPENMP
#include <omp.h>
#endif

typedef unsigned __int128 u128;
typedef uint64_t u64;

struct Fr { u64 v[4]; };

static const u64 P_[4] = {0x43e1f593f0000001ULL, 0x2833e84879b97091ULL,
                          0xb85045b68181585dULL, 0x30644e72e131a029ULL};
static const u64 NP64 = 0xc2e1f593efffffffULL;
static const Fr R2_ = {{0x1bb8e645ae216da7ULL, 0x53fe3ab1e35c59e3ULL,
                        0x8c49833d53bb8085ULL, 0x0216d0b17f4e44a5ULL}};
static const Fr R1_ = {{0xac96341c4ffffffbULL, 0x36fc76959f60cd29ULL,
                        0x666ea36f7879462eULL, 0x0e0a77c19a07df2fULL}};
static const Fr ZERO_ = {{0, 0, 0, 0}};

static inline bool geq_p(const Fr &a) {
    for (int i = 3; i >= 0; --i) {
        if (a.v[i] > P_[i]) return true;
        if (a.v[i] < P_[i]) return false;
    }
    return true;  // equal
}

static inline void sub_p(Fr &a) {
    u128 borrow = 0;
    for (int i = 0; i < 4; ++i) {
        u128 d = (u128)a.v[i] - P_[i] - borrow;
        a.v[i] = (u64)d;
        borrow = (d >> 64) ? 1 : 0;
    }
}

static inline void fr_add(const Fr &a, const Fr &b, Fr &out) {
    u128 carry = 0;
    for (int i = 0; i < 4; ++i) {
        u128 s = (u128)a.v[i] + b.v[i] + carry;
        out.v[i] = (u64)s;
        carry = s >> 64;
    }
    if (carry || geq_p(out)) sub_p(out);
}

static inline void fr_sub(const Fr &a, const Fr &b, Fr &out) {
    u128 borrow = 0;
    Fr t;
    for (int i = 0; i < 4; ++i) {
        u128 d = (u128)a.v[i] - b.v[i] - borrow;
        t.v[i] = (u64)d;
        borrow = (d >> 64) ? 1 : 0;
    }
    if (borrow) {
        u128 carry = 0;
        for (int i = 0; i < 4; ++i) {
            u128 s = (u128)t.v[i] + P_[i] + carry;
            t.v[i] = (u64)s;
            carry = s >> 64;
        }
    }
    out = t;
}

// CIOS Montgomery multiplication: out = a*b*R^-1 mod p.
static inline void fr_mont_mul(const Fr &a, const Fr &b, Fr &out) {
    u64 t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; ++i) {
        u128 carry = 0;
        for (int j = 0; j < 4; ++j) {
            u128 cur = (u128)a.v[j] * b.v[i] + t[j] + carry;
            t[j] = (u64)cur;
            carry = cur >> 64;
        }
        u128 s = (u128)t[4] + carry;
        t[4] = (u64)s;
        t[5] = (u64)(s >> 64);

        u64 m = t[0] * NP64;
        carry = ((u128)m * P_[0] + t[0]) >> 64;
        for (int j = 1; j < 4; ++j) {
            u128 cur = (u128)m * P_[j] + t[j] + carry;
            t[j - 1] = (u64)cur;
            carry = cur >> 64;
        }
        s = (u128)t[4] + carry;
        t[3] = (u64)s;
        t[4] = t[5] + (u64)(s >> 64);
        t[5] = 0;
    }
    out.v[0] = t[0]; out.v[1] = t[1]; out.v[2] = t[2]; out.v[3] = t[3];
    if (t[4] || geq_p(out)) sub_p(out);
}

static inline void to_mont(const Fr &a, Fr &out) { fr_mont_mul(a, R2_, out); }
static inline void from_mont(const Fr &a, Fr &out) {
    Fr one = {{1, 0, 0, 0}};
    fr_mont_mul(a, one, out);
}

static inline void fr_pow(const Fr &base_m, const u64 *exp, int exp_limbs,
                          Fr &out_m) {
    Fr result = R1_;  // 1 in Montgomery form
    Fr b = base_m;
    for (int i = 0; i < exp_limbs; ++i) {
        u64 e = exp[i];
        for (int bit = 0; bit < 64; ++bit) {
            if (e & 1) fr_mont_mul(result, b, result);
            fr_mont_mul(b, b, b);
            e >>= 1;
        }
    }
    out_m = result;
}

static inline void load(const uint8_t *p, Fr &a) { std::memcpy(a.v, p, 32); }
static inline void store(uint8_t *p, const Fr &a) { std::memcpy(p, a.v, 32); }

extern "C" {

// ---------------------------------------------------------------- basic ops

void gkr_batch_mul(const uint8_t *a, const uint8_t *b, uint8_t *out,
                   size_t n) {
#pragma omp parallel for schedule(static)
    for (long i = 0; i < (long)n; ++i) {
        Fr x, y, xm, ym, r, rs;
        load(a + 32 * i, x);
        load(b + 32 * i, y);
        to_mont(x, xm);
        to_mont(y, ym);
        fr_mont_mul(xm, ym, r);
        from_mont(r, rs);
        store(out + 32 * i, rs);
    }
}

void gkr_batch_add(const uint8_t *a, const uint8_t *b, uint8_t *out,
                   size_t n) {
#pragma omp parallel for schedule(static)
    for (long i = 0; i < (long)n; ++i) {
        Fr x, y, r;
        load(a + 32 * i, x);
        load(b + 32 * i, y);
        fr_add(x, y, r);
        store(out + 32 * i, r);
    }
}

// ------------------------------------------------------------------- MiMC7

// Round constants (canonical domain) are injected at init by the Python
// side (derived from the Keccak("mimc") chain, gkr_tpu_torch/mimc.py).
static Fr MIMC_CTS[91];
static int MIMC_READY = 0;

void gkr_mimc_init(const uint8_t *cts91) {
    for (int i = 0; i < 91; ++i) {
        Fr c;
        load(cts91 + 32 * i, c);
        to_mont(c, MIMC_CTS[i]);
    }
    MIMC_READY = 1;
}

static void mimc7_hash_m(const Fr &x_m, const Fr &k_m, Fr &out_m) {
    Fr h = ZERO_, t, t2, t4, t6;
    for (int i = 0; i < 91; ++i) {
        if (i == 0) {
            fr_add(x_m, k_m, t);
        } else {
            fr_add(h, k_m, t);
            fr_add(t, MIMC_CTS[i], t);
        }
        fr_mont_mul(t, t, t2);
        fr_mont_mul(t2, t2, t4);
        fr_mont_mul(t4, t2, t6);
        fr_mont_mul(t6, t, h);
    }
    fr_add(h, k_m, out_m);
}

void gkr_mimc_multi_hash(const uint8_t *elems, size_t n, uint8_t *out32) {
    Fr r = ZERO_;
    for (size_t i = 0; i < n; ++i) {
        Fr x, xm, h, s;
        load(elems + 32 * i, x);
        to_mont(x, xm);
        mimc7_hash_m(xm, r, h);
        fr_add(r, xm, s);
        fr_add(s, h, r);
    }
    Fr rs;
    from_mont(r, rs);
    store(out32, rs);
}

// ------------------------------------------------------- sumcheck kernels
// All table arguments are in MONTGOMERY domain (convert once per layer with
// gkr_to_mont / gkr_from_mont).

void gkr_to_mont(uint8_t *inout, size_t n) {
#pragma omp parallel for schedule(static)
    for (long i = 0; i < (long)n; ++i) {
        Fr x, xm;
        load(inout + 32 * i, x);
        to_mont(x, xm);
        store(inout + 32 * i, xm);
    }
}

void gkr_from_mont(uint8_t *inout, size_t n) {
#pragma omp parallel for schedule(static)
    for (long i = 0; i < (long)n; ++i) {
        Fr x, xs;
        load(inout + 32 * i, x);
        from_mont(x, xs);
        store(inout + 32 * i, xs);
    }
}

// eq table over a point of k coordinates (Montgomery domain), MSB-first.
void gkr_eq_table(const uint8_t *z_m, size_t k, uint8_t *out_m) {
    Fr one = R1_;
    store(out_m, one);
    size_t size = 1;
    for (long j = (long)k - 1; j >= 0; --j) {
        Fr zj, zc;
        load(z_m + 32 * j, zj);
        fr_sub(one, zj, zc);
        // out[0..size) are the current products; expand in place
        for (long s = (long)size - 1; s >= 0; --s) {
            Fr cur, lo, hi;
            load(out_m + 32 * s, cur);
            fr_mont_mul(cur, zc, lo);
            fr_mont_mul(cur, zj, hi);
            store(out_m + 32 * s, lo);
            store(out_m + 32 * (s + size), hi);
        }
        // interleave fix: entries were written as [lo_s at s, hi_s at s+size]
        size <<= 1;
    }
}

// phase-1 table build: for each gate (out,l,r):
//   HA1[l] += eqz[out];  HVAL[l] += eqz[out] * W[r]
// (HVAL is HA2 for add gates / HM for mult gates; pass ha1=nullptr to skip).
void gkr_scatter_phase1(const uint8_t *eqz_m, const uint8_t *w_m,
                        const int32_t *gates, size_t n_gates,
                        uint8_t *ha1_m, uint8_t *hval_m) {
    for (size_t g = 0; g < n_gates; ++g) {
        int32_t o = gates[3 * g], l = gates[3 * g + 1], r = gates[3 * g + 2];
        Fr e, wr, prod, cur;
        load(eqz_m + 32 * o, e);
        if (ha1_m) {
            load(ha1_m + 32 * l, cur);
            fr_add(cur, e, cur);
            store(ha1_m + 32 * l, cur);
        }
        load(w_m + 32 * r, wr);
        fr_mont_mul(e, wr, prod);
        load(hval_m + 32 * l, cur);
        fr_add(cur, prod, cur);
        store(hval_m + 32 * l, cur);
    }
}

// phase-2 table build: F[r] += eqz[out] * eqb[l] (* wb if wb != null)
void gkr_scatter_phase2(const uint8_t *eqz_m, const uint8_t *eqb_m,
                        const uint8_t *wb_m, const int32_t *gates,
                        size_t n_gates, uint8_t *f_m) {
    for (size_t g = 0; g < n_gates; ++g) {
        int32_t o = gates[3 * g], l = gates[3 * g + 1], r = gates[3 * g + 2];
        Fr e, el, prod, cur;
        load(eqz_m + 32 * o, e);
        load(eqb_m + 32 * l, el);
        fr_mont_mul(e, el, prod);
        if (wb_m) {
            Fr wb;
            load(wb_m, wb);
            fr_mont_mul(prod, wb, prod);
        }
        load(f_m + 32 * r, cur);
        fr_add(cur, prod, cur);
        store(f_m + 32 * r, cur);
    }
}

// phase-1 round evaluation: y_t = sum_s (HA1+HM)_t * W_t + HA2_t for
// t in {0,1,2}; tables have n entries, halves at n/2.  out = 3 x 32 bytes.
void gkr_phase1_eval(const uint8_t *w, const uint8_t *ha1,
                     const uint8_t *ha2, const uint8_t *hm, size_t n,
                     uint8_t *y_out) {
    size_t half = n / 2;
    Fr acc[3] = {ZERO_, ZERO_, ZERO_};
#ifdef _OPENMP
    int nt = omp_get_max_threads();
#else
    int nt = 1;
#endif
#pragma omp parallel
    {
        Fr local[3] = {ZERO_, ZERO_, ZERO_};
#pragma omp for schedule(static) nowait
        for (long s = 0; s < (long)half; ++s) {
            Fr w0, w1, a0, a1, h0, h1, m0, m1;
            load(w + 32 * s, w0); load(w + 32 * (s + half), w1);
            load(ha1 + 32 * s, a0); load(ha1 + 32 * (s + half), a1);
            load(ha2 + 32 * s, h0); load(ha2 + 32 * (s + half), h1);
            load(hm + 32 * s, m0); load(hm + 32 * (s + half), m1);
            Fr wt = w0, at = a0, ht = h0, mt = m0;
            for (int t = 0; t < 3; ++t) {
                if (t > 0) {
                    Fr d;
                    fr_sub(w1, w0, d); fr_add(wt, d, wt);
                    // recompute via wt = w0 + t*(w1-w0) incrementally
                    fr_sub(a1, a0, d); fr_add(at, d, at);
                    fr_sub(h1, h0, d); fr_add(ht, d, ht);
                    fr_sub(m1, m0, d); fr_add(mt, d, mt);
                }
                Fr am, prod, term;
                fr_add(at, mt, am);
                fr_mont_mul(am, wt, prod);
                fr_add(prod, ht, term);
                fr_add(local[t], term, local[t]);
            }
        }
#pragma omp critical
        for (int t = 0; t < 3; ++t) fr_add(acc[t], local[t], acc[t]);
    }
    (void)nt;
    for (int t = 0; t < 3; ++t) store(y_out + 32 * t, acc[t]);
}

// phase-2 round evaluation: y_t = sum FA_t*(wb + W_t) + FMwb_t*W_t.
void gkr_phase2_eval(const uint8_t *w, const uint8_t *fa,
                     const uint8_t *fmwb, const uint8_t *wb32, size_t n,
                     uint8_t *y_out) {
    size_t half = n / 2;
    Fr wb;
    load(wb32, wb);
    Fr acc[3] = {ZERO_, ZERO_, ZERO_};
#pragma omp parallel
    {
        Fr local[3] = {ZERO_, ZERO_, ZERO_};
#pragma omp for schedule(static) nowait
        for (long s = 0; s < (long)half; ++s) {
            Fr w0, w1, f0, f1, g0, g1;
            load(w + 32 * s, w0); load(w + 32 * (s + half), w1);
            load(fa + 32 * s, f0); load(fa + 32 * (s + half), f1);
            load(fmwb + 32 * s, g0); load(fmwb + 32 * (s + half), g1);
            Fr wt = w0, fat = f0, fmt = g0;
            for (int t = 0; t < 3; ++t) {
                if (t > 0) {
                    Fr d;
                    fr_sub(w1, w0, d); fr_add(wt, d, wt);
                    fr_sub(f1, f0, d); fr_add(fat, d, fat);
                    fr_sub(g1, g0, d); fr_add(fmt, d, fmt);
                }
                Fr s1, p1, p2, term;
                fr_add(wb, wt, s1);
                fr_mont_mul(fat, s1, p1);
                fr_mont_mul(fmt, wt, p2);
                fr_add(p1, p2, term);
                fr_add(local[t], term, local[t]);
            }
        }
#pragma omp critical
        for (int t = 0; t < 3; ++t) fr_add(acc[t], local[t], acc[t]);
    }
    for (int t = 0; t < 3; ++t) store(y_out + 32 * t, acc[t]);
}

// In-place Möbius (finite-difference) transform over n canonical values,
// MSB-first variable order (matches gkr_tpu_torch.mle.mobius / the device
// torcheng.backend._mobius_dev): per stage, hi_half -= lo_half within each
// block.  The
// sparse-MLE materialization path (convert.rs:840-847 get_multi_ext):
// canonical-domain adds/subs only, no Montgomery conversion needed.
void gkr_mobius(uint8_t *inout, size_t n) {
    for (size_t half = n >> 1; half >= 1; half >>= 1) {
        size_t block = half << 1;
        long nblocks = (long)(n / block);
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n >= 4096)
#endif
        for (long b = 0; b < nblocks; ++b) {
            uint8_t *base = inout + (size_t)b * block * 32;
            for (size_t i = 0; i < half; ++i) {
                Fr lo, hi;
                load(base + i * 32, lo);
                load(base + (half + i) * 32, hi);
                fr_sub(hi, lo, hi);
                store(base + (half + i) * 32, hi);
            }
        }
        if (half == 1) break;
    }
}

// in-place fold: table[0..n/2) = lo + r*(hi - lo); Montgomery domain.
void gkr_fold(uint8_t *table, size_t n, const uint8_t *r32) {
    size_t half = n / 2;
    Fr r;
    load(r32, r);
#pragma omp parallel for schedule(static)
    for (long s = 0; s < (long)half; ++s) {
        Fr lo, hi, d, prod, res;
        load(table + 32 * s, lo);
        load(table + 32 * (s + half), hi);
        fr_sub(hi, lo, d);
        fr_mont_mul(d, r, prod);
        fr_add(lo, prod, res);
        store(table + 32 * s, res);
    }
}

// multi-fold: fold four same-size tables with the same r (one pass).
void gkr_fold4(uint8_t *t0, uint8_t *t1, uint8_t *t2, uint8_t *t3,
               size_t n, const uint8_t *r32) {
    gkr_fold(t0, n, r32);
    if (t1) gkr_fold(t1, n, r32);
    if (t2) gkr_fold(t2, n, r32);
    if (t3) gkr_fold(t3, n, r32);
}

int gkr_version() { return 1; }

int gkr_num_threads() {
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 1;
#endif
}

}  // extern "C"
