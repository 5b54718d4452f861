// Fused leapfrog + log-prob kernel for Hopper (sm_90a): B6.
//
// Replaces the Pallas TPU kernel of enflows_tpu/ops/pallas/leapfrog.py:
//   B6 leapfrog_kernel <- _fused_leapfrog_impl (kernel _build_leapfrog_kernel,
//                         sweep _chain_fwd_bwd)
//
// L velocity-Verlet steps of every chain with a diagonal inverse mass im, on
// logp(q) = sum_j N(f(q)_j; mu_j, 1 / iv_j) + ladj_f(q) for a fusible chain f
// (the stages of elementwise.cu). A trajectory takes L + 1 gradients, one at
// q_0 and one per step; logp_0 comes from the first and logp_L from the last.
// No parameter gradients: no atomics, no partial sums, a deterministic
// result. The step size is read from device memory.
//
// What bounds it on an H100: operations, and among them the transcendentals.
// At the BASELINE leapfrog config (8192 chains, d = 50, L = 64; the chain
// Householder(4 reflections) -> CenterContract -> Johnson) the state moves
// once (6.6 MB, 2 us at 3.35 TB/s). Each of the 65 gradients of a chain
// needs two products with the Householder stage, 4 d FLOP per reflection
// each, and per element the elementwise stages' special functions: 2 exp,
// 1 log1p, 1 log, 1 reciprocal square root and 3 reciprocals here (2 more
// logs in the two end gradients), which the MUFU units run at 16 per
// clock per SM against 128 FMAs.
//
// The design (one thread block holds many chains; nothing but the launch's
// prologue is shared between them):
//
// * A chain per lane group. G lanes of a warp (G a power of two <= 32) own
//   one chain; lane l owns the E elements j = c0 + l + G i (E = 1, 2 or 4, a
//   template parameter). q, p, the gradient and the running stage values
//   stay in registers for the whole trajectory. Without a Householder stage
//   the elements never meet except in the two logp sums, so a chain wider
//   than G E (up to d = 2048) is walked in column tiles of G E, each a whole
//   trajectory; with one, d <= 128 = 32 x 4 is a single tile.
// * Householder stages as reflections. The wrapper passes each stage's
//   normalized rows w_r in the order they are applied; y = x Q^T is
//   x <- x - 2 (w_r . x) w_r for r = 0..k-1 and the adjoint c Q takes the
//   same reflections in reverse. A dot product is a lane-local partial sum
//   (i = 0..E-1) and log2(G) __shfl_xor_sync steps (offsets 1, 2, 4, ...),
//   after which every lane of the group holds the same sum. The rows sit in
//   shared memory once per block, zero beyond d. A stage with 2 k > d
//   reflections (4 d k FLOP > the dense 2 d^2), or one whose rows do not fit
//   the block's shared memory, is applied as its dense Q (HD below): x[m]
//   broadcast by __shfl_sync, Q^T / Q read from device memory (L1-cached).
// * The adjoint without recomputation. With the ladj's cotangent fixed at 1,
//   an elementwise stage's input cotangent is ct = cy A + B, where A = dy/dt
//   and B = d(ladj term)/dt depend on the stage's input only. The forward
//   folds every run of elementwise stages between two Householder stages
//   into one pair per element (P <- P A, B <- B + P_old B_k), so the adjoint
//   sweep is one FMA per run and element plus the Householder adjoints: no
//   stage is evaluated twice. A run's pair is held until the sweep comes
//   back across the Householder stage after it: in registers for the first
//   LF_NREG such runs (template NREG), beyond that in lane-private shared
//   memory (each lane reads only its own words, no barrier). The last run
//   is consumed at once.
// * Transcendentals out of the loop. Each block derives its columns'
//   parameter-only constants once (1/b, 1/lambda, 1/delta, delta/lambda,
//   e^{-2ab}, b (c +- a), ...; log|a|, log|delta/lambda| and the Gaussian's
//   -(log 2 pi - log iv)/2 summed into one constant per column) into shared
//   memory; lanes read them there (the lanes of a group read consecutive
//   words, the groups of a warp the same ones). The ladj terms that depend
//   on the state are computed only in the two gradients that give logp_0
//   and logp_L (template ENDS), not in the L - 1 between them.
// * No __syncthreads in the trajectory: the only barriers bracket the
//   prologue that writes a tile's constants and the rows.
// * Occupancy: 128-thread blocks; d = 50 takes G = 16, E = 4 (two chains a
//   warp), so 8192 chains are 1024 blocks, 5 per SM at once (96 registers,
//   see lf_min_blocks). G = 32, E = 2 (one chain a warp, 64 registers, 8
//   blocks per SM) was slower on the card (PERF.md).
//
// Fast math in the trajectory's stage bodies: exp, log, reciprocal and
// reciprocal square root as single approximate MUFU instructions with
// denormals flushed (PTX ex2/lg2/rcp/rsqrt.approx.ftz, what
// -use_fast_math makes of __expf, __logf, __fdividef and rsqrtf); log1pf
// stays accurate. chip_smoke.py holds the result to the float64 plain
// version under B6's unchanged gates. The constants' prologue keeps the
// accurate functions.

#include <cuda_runtime.h>

#include "stages.cuh"

// B6 only: a Householder stage applied as its dense Q (device memory).
enum { HD = 6 };

#define LF_FULL 0xffffffffu
#define LF_BLOCK_MAX 128     // threads per block at most (_LF_BLOCK)
#define LF_MIN_BLOCKS 8      // blocks per SM at E = 1, 2: 64 registers
#define LF_MIN_BLOCKS_E4 5   // at E = 4: 96 registers
#define LF_MIN_BLOCKS_RUNS 4 // the kernels with runs in registers
#define LF_NREG 2            // runs held in registers (template NREG)
#define LF_NCONST 5          // constants per stage and column

// The plan: one int4 per stage, (code, a, b, slot).
//   elementwise (SS..JI): a = first parameter slot in P;
//   HH (reflections):     a = first row in the rows buffer, b = k;
//   HD (dense):           a = index of its Q in Q and Qt;
//   slot (HH, HD): the store slot of the run before the stage, -1 if that
//   run is empty; -1 for an elementwise stage.
struct LfPlan {
  int n_stages;
  int4 st[ENF_MAX_STAGES];
};

struct LfArgs {
  const float* q0;
  const float* p0;
  float* qo;
  float* po;
  float* lp0;
  float* lpL;
  const float* eps;
  const float* im;
  const float* mu;
  const float* iv;
  const float* P;     // elementwise parameters, (slots, d)
  const float* rows;  // normalized reflection rows, (n_rows, d)
  const float* Q;     // dense stages' Q, (n_dense, d, d)
  const float* Qt;    // and Q^T
  long long n;
  int d, G, n_rows, num_steps;
};

// Where a gradient finds its operands.
struct LfCtx {
  const int4* st;     // the plan's stages, in shared memory
  int nst;
  const float* cst;   // the tile's constants, + lane offset
  const float* rows;  // the rows in shared memory, + lane offset
  const float* Q;
  const float* Qt;
  float* store;       // this thread's lane-private words
  int DC, G, lig, d, stride;
  int nv;             // valid columns from the tile's first: d - c0
  int vm;             // bit i: the lane's element i is valid
};

// The constants of the columns c0 .. c0 + DC - 1 (clamped to d - 1 beyond
// d, with im = 0 there so that a pad element never moves). Row r of cst
// holds one constant for every column:
//   0 mu, 1 iv, 2 im, 3 the column's constant log-density term,
//   4 + 5 k + c: stage k's constant c (see the stage bodies below).
__device__ __forceinline__ void lf_consts(float* cst, const int4* st,
                                          int nst, const LfArgs& a, int c0,
                                          int DC) {
  const int d = a.d;
  for (int col = threadIdx.x; col < DC; col += blockDim.x) {
    const int jj = c0 + col, j = min(jj, d - 1);
    const float ivj = __ldg(a.iv + j);
    float lc = -0.5f * (ENF_LOG_2PI - logf(ivj));
    for (int k = 0; k < nst; ++k) {
      const int code = st[k].x, s = st[k].y;
      float* kc = cst + (4 + LF_NCONST * k) * DC + col;
      if (code == SS) {
        const float av = par(a.P, s, d, j);
        kc[0] = av;
        kc[DC] = par(a.P, s + 1, d, j);
        lc += logf(fabsf(av));
      } else if (code == CC) {
        const float av = par(a.P, s, d, j), b = par(a.P, s + 1, d, j),
                    c = par(a.P, s + 2, d, j);
        kc[0] = b;
        kc[DC] = b * (c + av);
        kc[2 * DC] = b * (c - av);
        kc[3 * DC] = 1.f / b;
      } else if (code == CS) {
        const float av = par(a.P, s, d, j), b = par(a.P, s + 1, d, j);
        const float ab = av * b;
        kc[0] = b;
        kc[DC] = par(a.P, s + 2, d, j);
        kc[2 * DC] = ab - ENF_LOG2;
        kc[3 * DC] = 1.f / b;
        kc[4 * DC] = expf(-2.f * ab);
      } else if (code == JF) {
        const float delta = par(a.P, s + 1, d, j),
                    lam = par(a.P, s + 3, d, j);
        kc[0] = par(a.P, s, d, j);
        kc[DC] = delta;
        kc[2 * DC] = par(a.P, s + 2, d, j);
        kc[3 * DC] = 1.f / lam;
        kc[4 * DC] = delta / lam;
        lc += logf(fabsf(delta / lam));
      } else if (code == JI) {
        const float delta = par(a.P, s + 1, d, j),
                    lam = par(a.P, s + 3, d, j);
        kc[0] = par(a.P, s, d, j);
        kc[DC] = 1.f / delta;
        kc[2 * DC] = lam;
        kc[3 * DC] = par(a.P, s + 2, d, j);
        kc[4 * DC] = lam / delta;
        lc += logf(fabsf(lam / delta)) - ENF_LOG2;
      }
    }
    cst[col] = __ldg(a.mu + j);
    cst[DC + col] = ivj;
    cst[2 * DC + col] = jj < d ? __ldg(a.im + j) : 0.f;
    cst[3 * DC + col] = lc;
  }
}

// ---------------------------------------------------------------------------
// Elementwise stages at the lane's E elements: x <- y(x); the run's pair
// (P, B) <- (P A, B + P Bk) with A = dy/dt and Bk = d(ladj term)/dt; with
// ENDS, ls += the state-dependent part of the ladj term of each valid
// element (bit i of vm), stage by stage and element by element. kc points
// at the stage's first constant for the lane's first column. The arithmetic
// follows stage_fwd / stage_bwd of stages.cuh at ce = 1, with the
// approximate special functions below and CenterContract's two softplus
// terms taken through one log1p.

// The special functions of the stage bodies, one MUFU instruction each
// (what -use_fast_math makes of expf, logf, 1 / x and rsqrtf; the build
// keeps accurate math for every other kernel): approximate, denormals
// flushed to zero.
__device__ __forceinline__ float lf_exp(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v * 1.44269504088896341f));
  return r;
}

__device__ __forceinline__ float lf_log(float v) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r * ENF_LOG2;
}

__device__ __forceinline__ float lf_rcp(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float lf_rsqrt(float v) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void lf_fold(float& P, float& B, float A,
                                        float Bk) {
  B = fmaf(P, Bk, B);
  P *= A;
}

template <int E, bool ENDS>
__device__ __forceinline__ void lf_ss(float (&x)[E], float (&P)[E],
                                      const float* kc, int DC, int G) {
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const float a = kc[G * i], b = kc[G * i + DC];
    x[i] = x[i] * a + b;
    P[i] *= a;  // Bk = 0
  }
}

// CenterContract: constants b, b (c + a), b (c - a), 1/b. The softplus
// difference sp1 - sp2 = max(u1, 0) - max(-u2, 0) + log1p((e1 - e2) r2)
// with r2 = 1 / (1 + e2), one log1p where stage_fwd takes two.
template <int E, bool ENDS>
__device__ __forceinline__ void lf_cc(float (&x)[E], float (&P)[E],
                                      float (&B)[E], float& ls, int vm,
                                      const float* kc, int DC, int G) {
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const float* k = kc + G * i;
    const float b = k[0];
    const float u1 = fmaf(b, x[i], -k[DC]), u2 = fmaf(b, x[i], -k[2 * DC]);
    const float e1 = lf_exp(-fabsf(u1)), e2 = lf_exp(-fabsf(u2));
    const float r1 = lf_rcp(1.f + e1), r2 = lf_rcp(1.f + e2);
    const float s1 = (u1 >= 0.f ? 1.f : e1) * r1;
    const float s2 = (-u2 >= 0.f ? 1.f : e2) * r2;
    const float S = s1 + s2;
    const float p1 = e1 * r1 * r1, p2 = e2 * r2 * r2;
    x[i] = (fmaxf(u1, 0.f) - fmaxf(-u2, 0.f) + log1pf((e1 - e2) * r2)) *
           k[3 * DC];
    lf_fold(P[i], B[i], S, b * (p1 - p2) * lf_rcp(S));
    if (ENDS && (vm >> i & 1)) ls += lf_log(S);
  }
}

// CenterStretch: constants b, c, ab - log 2, 1/b, e^{-2ab}.
template <int E, bool ENDS>
__device__ __forceinline__ void lf_cs(float (&x)[E], float (&P)[E],
                                      float (&B)[E], float& ls, int vm,
                                      const float* kc, int DC, int G) {
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const float* k = kc + G * i;
    const float b = k[0], e2ab = k[4 * DC];
    const float t = x[i];
    const float m = fmaxf(fabsf(b * t), 1e-6f);
    const float em = lf_exp(-m);
    const float one_m = 1.f - em;
    const float r2 = one_m * one_m + 4.f * e2ab * em;
    const float denom = one_m + r2 * lf_rsqrt(r2);
    const float log_s = m + k[2 * DC] + lf_log(denom);
    x[i] = k[DC] + sgnf(t) * log_s * k[3 * DC];
    // The contract sigmoids at y (stage_bwd's CS branch): ae = e^{ab - w},
    // q = ae e^{-2ab}; S = s1 + s2 is also the forward's s_sum.
    const float ae = 2.f * em * lf_rcp(denom);
    const float q = ae * e2ab;
    const float A = lf_rcp(1.f + ae), rq = lf_rcp(1.f + q);
    const float Bq = q * rq;
    const float pA = A * A * ae, pB = Bq * rq;
    const float S = A + Bq;
    const float iS = lf_rcp(S);
    const float Sy = b * (t >= 0.f ? pA - pB : pB - pA);
    lf_fold(P[i], B[i], iS, -Sy * iS * iS);
    if (ENDS && (vm >> i & 1)) ls -= lf_log(S);
  }
}

// Johnson: constants gamma, delta, xi, 1/lambda, delta/lambda.
template <int E, bool ENDS>
__device__ __forceinline__ void lf_jf(float (&x)[E], float (&P)[E],
                                      float (&B)[E], float& ls, int vm,
                                      const float* kc, int DC, int G) {
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const float* k = kc + G * i;
    const float il = k[3 * DC];
    const float u = (x[i] - k[2 * DC]) * il;
    const float s2 = 1.f + u * u;
    const float rs = lf_rsqrt(s2);
    const float s = s2 * rs;
    x[i] = k[0] + k[DC] * (sgnf(u) * lf_log(fabsf(u) + s));
    lf_fold(P[i], B[i], k[4 * DC] * rs, -u * il * rs * rs);
    if (ENDS && (vm >> i & 1)) ls -= lf_log(s);
  }
}

// JohnsonInv: constants gamma, 1/delta, lambda, xi, lambda/delta.
template <int E, bool ENDS>
__device__ __forceinline__ void lf_ji(float (&x)[E], float (&P)[E],
                                      float (&B)[E], float& ls, int vm,
                                      const float* kc, int DC, int G) {
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const float* k = kc + G * i;
    const float id = k[DC];
    const float v = (x[i] - k[0]) * id;
    const float av = fabsf(v);
    // e^{|v|} directly: 1 / e^{-|v|} would turn inf from |v| ~ 87.3, where
    // ex2.approx.ftz flushes e^{-|v|} to 0; this is finite to |v| ~ 88.7.
    const float ei = lf_exp(-av);
    const float e = lf_exp(av);
    const float sg = sgnf(v);
    const float ei2 = ei * ei;
    x[i] = k[2 * DC] * (sg * 0.5f * (e - ei)) + k[3 * DC];
    const float tanh_v = sg * (1.f - ei2) * lf_rcp(1.f + ei2);
    lf_fold(P[i], B[i], k[4 * DC] * (0.5f * (e + ei)), tanh_v * id);
    if (ENDS && (vm >> i & 1)) ls += av + log1pf(ei2);
  }
}

// ---------------------------------------------------------------------------
// Householder stages.

// k reflections x <- x - 2 (w_r . x) w_r, in order r = 0..k-1, or in
// reverse for the adjoint. w: the first row in shared memory at the lane's
// first column (rows of DC floats, zero beyond d).
template <int E>
__device__ __forceinline__ void lf_reflect(float (&x)[E], const float* w,
                                           int k, int DC, int G,
                                           bool adjoint) {
  for (int rr = 0; rr < k; ++rr) {
    const float* row = w + (adjoint ? k - 1 - rr : rr) * DC;
    float wv[E];
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      wv[i] = row[G * i];
      dot = fmaf(wv[i], x[i], dot);
    }
    for (int off = 1; off < G; off <<= 1)
      dot += __shfl_xor_sync(LF_FULL, dot, off);
    const float m2 = -2.f * dot;
#pragma unroll
    for (int i = 0; i < E; ++i) x[i] = fmaf(m2, wv[i], x[i]);
  }
}

// x <- x M with M (d, d) row-major in device memory: M = Q^T forward, M = Q
// for the adjoint. x[m] is broadcast to the group by __shfl_sync; the lanes
// read a row of M at consecutive columns.
template <int E>
__device__ __forceinline__ void lf_dense(float (&x)[E],
                                         const float* __restrict__ M, int d,
                                         int G, int lig) {
  float y[E];
#pragma unroll
  for (int i = 0; i < E; ++i) y[i] = 0.f;
#pragma unroll
  for (int i2 = 0; i2 < E; ++i2) {
    for (int l = 0; l < G; ++l) {
      const int m = l + G * i2;
      const float xm = __shfl_sync(LF_FULL, x[i2], l, G);
      if (m < d) {
        const float* row = M + (size_t)m * d;
#pragma unroll
        for (int i = 0; i < E; ++i) {
          const int j = lig + G * i;
          if (j < d) y[i] = fmaf(xm, __ldg(row + j), y[i]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < E; ++i) x[i] = y[i];
}

// The runs' pairs held across Householder stages: slots below NREG in
// registers (indexed by unrolled constants only), the rest in lane-private
// shared memory.
template <int E, int NREG>
struct LfRuns {
  float p[NREG > 0 ? NREG : 1][E], b[NREG > 0 ? NREG : 1][E];

  __device__ __forceinline__ void save(int s, const float (&P)[E],
                                       const float (&B)[E],
                                       const LfCtx& c) {
    if (s < NREG) {
#pragma unroll
      for (int r = 0; r < NREG; ++r)
        if (r == s) {
#pragma unroll
          for (int i = 0; i < E; ++i) {
            p[r][i] = P[i];
            b[r][i] = B[i];
          }
        }
    } else {
      float* w = c.store + (size_t)(s - NREG) * 2 * E * c.stride;
#pragma unroll
      for (int i = 0; i < E; ++i) {
        w[2 * i * c.stride] = P[i];
        w[(2 * i + 1) * c.stride] = B[i];
      }
    }
  }

  // c <- c P_s + B_s.
  __device__ __forceinline__ void apply(int s, float (&x)[E],
                                        const LfCtx& c) const {
    if (s < NREG) {
#pragma unroll
      for (int r = 0; r < NREG; ++r)
        if (r == s) {
#pragma unroll
          for (int i = 0; i < E; ++i) x[i] = fmaf(x[i], p[r][i], b[r][i]);
        }
    } else {
      const float* w = c.store + (size_t)(s - NREG) * 2 * E * c.stride;
#pragma unroll
      for (int i = 0; i < E; ++i)
        x[i] = fmaf(x[i], w[2 * i * c.stride], w[(2 * i + 1) * c.stride]);
    }
  }
};

// One gradient of logp at q (the lane's E elements) into g; with ENDS also
// the lane's share of logp (valid elements only) added to lsum: the ladj
// terms stage by stage, then the base's terms.
template <int E, int NREG, bool ENDS>
__device__ __forceinline__ void lf_grad(const LfCtx& c, const float (&q)[E],
                                        float (&g)[E], float& lsum) {
  float x[E], P[E], B[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    x[i] = q[i];
    P[i] = 1.f;
    B[i] = 0.f;
  }
  LfRuns<E, NREG> runs;
  const int nst = c.nst, DC = c.DC, G = c.G;
  for (int k = 0; k < nst; ++k) {
    const int4 w = c.st[k];
    const float* kc = c.cst + (4 + LF_NCONST * k) * DC;
    switch (w.x) {
      case SS: lf_ss<E, ENDS>(x, P, kc, DC, G); break;
      case CC: lf_cc<E, ENDS>(x, P, B, lsum, c.vm, kc, DC, G); break;
      case CS: lf_cs<E, ENDS>(x, P, B, lsum, c.vm, kc, DC, G); break;
      case JF: lf_jf<E, ENDS>(x, P, B, lsum, c.vm, kc, DC, G); break;
      case JI: lf_ji<E, ENDS>(x, P, B, lsum, c.vm, kc, DC, G); break;
      default:  // HH, HD: close the run before the stage
        if (w.w >= 0) runs.save(w.w, P, B, c);
#pragma unroll
        for (int i = 0; i < E; ++i) {
          P[i] = 1.f;
          B[i] = 0.f;
        }
        if (w.x == HH)
          lf_reflect<E>(x, c.rows + w.y * DC, w.z, DC, G, false);
        else
          lf_dense<E>(x, c.Qt + (size_t)w.y * c.d * c.d, c.d, G, c.lig);
    }
  }
  // The base's cotangent cy = -(y - mu) iv, through the last run.
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const float dv = x[i] - c.cst[G * i];
    const float ivj = c.cst[DC + G * i];
    if (ENDS && (c.vm >> i & 1))
      lsum += -0.5f * dv * dv * ivj + c.cst[3 * DC + G * i];
    x[i] = fmaf(-dv * ivj, P[i], B[i]);
  }
  // The adjoint sweep: Householder stages in reverse, each followed by the
  // run before it.
  for (int k = nst - 1; k >= 0; --k) {
    const int4 w = c.st[k];
    if (w.x < HH) continue;
    if (w.x == HH)
      lf_reflect<E>(x, c.rows + w.y * DC, w.z, DC, G, true);
    else
      lf_dense<E>(x, c.Q + (size_t)w.y * c.d * c.d, c.d, G, c.lig);
    if (w.w >= 0) runs.apply(w.w, x, c);
  }
#pragma unroll
  for (int i = 0; i < E; ++i) g[i] = x[i];
}

// B6: replaces _fused_leapfrog_impl (ops/pallas/leapfrog.py:157-224). One
// lane group per chain; see the header for the design.
// Blocks per SM each instantiation is compiled for, the most at which
// ptxas spills nothing: E = 4 spills a few bytes at 64, 72 and 80
// registers, so 8192 chains at d = 50 (1024 blocks) take 1.55 waves of
// 5 x 132 blocks instead of one of 8 x 132; the kernels that hold runs in
// registers need ~125.
constexpr int lf_min_blocks(int E, int NREG) {
  return NREG > 0 ? LF_MIN_BLOCKS_RUNS
                  : E == 4 ? LF_MIN_BLOCKS_E4 : LF_MIN_BLOCKS;
}

template <int E, int NREG>
__global__ void __launch_bounds__(LF_BLOCK_MAX, lf_min_blocks(E, NREG))
    leapfrog_kernel(const LfArgs a, const LfPlan plan) {
  // Shared memory: the plan, the tile's constants, the rows, the
  // lane-private runs.
  extern __shared__ int4 smem[];
  const int G = a.G, DC = G * E, d = a.d, nst = plan.n_stages;
  int4* st = smem;
  float* cst = reinterpret_cast<float*>(st + nst);
  float* rows = cst + (4 + LF_NCONST * nst) * DC;
  for (int k = threadIdx.x; k < nst; k += blockDim.x) st[k] = plan.st[k];
  const int lig = threadIdx.x & (G - 1);
  const long long chain =
      (long long)blockIdx.x * (blockDim.x / G) + threadIdx.x / G;
  const bool live = chain < a.n;
  const long long cs = live ? chain : a.n - 1;
  const float eps = __ldg(a.eps), half_eps = 0.5f * eps;
  const int L = a.num_steps;

  for (int e = threadIdx.x; e < a.n_rows * DC; e += blockDim.x) {
    const int r = e / DC, col = e - r * DC;
    rows[e] = col < d ? __ldg(a.rows + (size_t)r * d + col) : 0.f;
  }
  LfCtx c{st, nst, cst + lig, rows + lig, a.Q, a.Qt,
          rows + a.n_rows * DC + threadIdx.x, DC, G, lig, d,
          (int)blockDim.x, d};
  float lp0 = 0.f, lpL = 0.f;
  for (int c0 = 0; c0 < d; c0 += DC) {
    __syncthreads();  // the previous tile's constants are read
    lf_consts(cst, st, nst, a, c0, DC);
    __syncthreads();
    c.nv = d - c0;
    c.vm = 0;
#pragma unroll
    for (int i = 0; i < E; ++i) c.vm |= (lig + G * i < c.nv) << i;
    const float* im = cst + 2 * DC + lig;
    const float* q0 = a.q0 + cs * d + c0 + lig;
    const float* p0 = a.p0 + cs * d + c0 + lig;
    float q[E], p[E];
#pragma unroll
    for (int i = 0; i < E; ++i) {
      q[i] = c.vm >> i & 1 ? q0[G * i] : 0.f;
      p[i] = c.vm >> i & 1 ? p0[G * i] : 0.f;
    }
    // The trajectory: L + 1 gradients, the ladj terms at the ends only.
    // Step s is p += eps/2 g(q); q += eps p im; p += eps/2 g(q). Both half
    // kicks with one gradient follow it at once (the end of step s, the
    // start of step s + 1), so no gradient is carried from step to step.
    for (int step = 0; step <= L; ++step) {
      if (step > 0) {
#pragma unroll
        for (int i = 0; i < E; ++i) q[i] = fmaf(eps * p[i], im[G * i], q[i]);
      }
      float g[E];
      if (step == 0 || step == L) {
        float ls = 0.f;
        lf_grad<E, NREG, true>(c, q, g, ls);
        if (step == 0) lp0 += ls;
        if (step == L) lpL += ls;
      } else {
        float unused = 0.f;
        lf_grad<E, NREG, false>(c, q, g, unused);
      }
#pragma unroll
      for (int i = 0; i < E; ++i) {
        if (step > 0) p[i] = fmaf(half_eps, g[i], p[i]);
        if (step < L) p[i] = fmaf(half_eps, g[i], p[i]);
      }
    }
    if (live) {
      float* qo = a.qo + cs * d + c0 + lig;
      float* po = a.po + cs * d + c0 + lig;
#pragma unroll
      for (int i = 0; i < E; ++i)
        if (c.vm >> i & 1) {
          qo[G * i] = q[i];
          po[G * i] = p[i];
        }
    }
  }
  for (int off = 1; off < G; off <<= 1) {
    lp0 += __shfl_xor_sync(LF_FULL, lp0, off);
    lpL += __shfl_xor_sync(LF_FULL, lpL, off);
  }
  if (live && lig == 0) {
    a.lp0[cs] = lp0;
    a.lpL[cs] = lpL;
  }
}

template <int E, int NREG>
static cudaError_t launch_leapfrog(const LfArgs& a, const LfPlan& plan,
                                   int grid, int block, int smem,
                                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      leapfrog_kernel<E, NREG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  leapfrog_kernel<E, NREG><<<grid, block, smem, stream>>>(a, plan);
  return cudaGetLastError();
}

static int lf_make_plan(LfPlan* plan, const int* words, int n_stages) {
  if (n_stages < 0 || n_stages > ENF_MAX_STAGES) return 1;
  plan->n_stages = n_stages;
  for (int k = 0; k < n_stages; ++k)
    if (words[4 * k] < SS || words[4 * k] > HD) return 1;
  for (int k = 0; k < ENF_MAX_STAGES; ++k)
    plan->st[k] = k < n_stages ? make_int4(words[4 * k], words[4 * k + 1],
                                           words[4 * k + 2], words[4 * k + 3])
                               : make_int4(0, 0, 0, -1);
  return 0;
}

static bool lf_geometry_ok(int G, int E, int nreg, int block) {
  return G >= 1 && G <= 32 && (G & (G - 1)) == 0 &&
         (E == 1 || E == 2 || E == 4) && (nreg == 0 || nreg == LF_NREG) &&
         block >= 32 && block <= LF_BLOCK_MAX && block % 32 == 0;
}

// The template instantiation for (E, nreg), called with a functor.
struct LfLaunch {
  const LfArgs& a;
  const LfPlan& plan;
  int grid, block, smem;
  cudaStream_t stream;
  template <int E, int NREG>
  cudaError_t run() const {
    return launch_leapfrog<E, NREG>(a, plan, grid, block, smem, stream);
  }
};

struct LfQuery {
  int block, smem;
  int *blocks_per_sm, *regs, *local_bytes;
  template <int E, int NREG>
  cudaError_t run() const {
    cudaError_t err = cudaFuncSetAttribute(
        leapfrog_kernel<E, NREG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, leapfrog_kernel<E, NREG>);
    if (err != cudaSuccess) return err;
    *regs = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, leapfrog_kernel<E, NREG>, block, smem);
  }
};

template <typename F>
static cudaError_t lf_dispatch(int E, int nreg, const F& f) {
  switch (E * 8 + nreg) {
    case 8: return f.template run<1, 0>();
    case 8 + LF_NREG: return f.template run<1, LF_NREG>();
    case 16: return f.template run<2, 0>();
    case 16 + LF_NREG: return f.template run<2, LF_NREG>();
    case 32: return f.template run<4, 0>();
    case 32 + LF_NREG: return f.template run<4, LF_NREG>();
  }
  return cudaErrorInvalidValue;
}

// C interface: launches on `stream`, does not synchronize, and returns
// cudaGetLastError() after the launch (0 on success). words: 4 ints per
// stage (LfPlan); G lanes per chain, E elements per lane, nreg runs held in
// registers (0 or LF_NREG), n_rows reflection rows; block threads, smem
// bytes (the wrapper's leapfrog_geometry).
extern "C" int enf_fused_leapfrog(const float* q0, const float* p0, float* qo,
                                  float* po, float* lp0, float* lpL,
                                  const float* eps, const float* im,
                                  const float* mu, const float* iv,
                                  const float* P, const float* rows,
                                  const float* Q, const float* Qt,
                                  const int* words, int n_stages, long long n,
                                  int d, int G, int E, int nreg, int n_rows,
                                  int num_steps, int grid, int block,
                                  int smem, void* stream) {
  LfPlan plan;
  if (lf_make_plan(&plan, words, n_stages) || n <= 0 || d <= 0 ||
      num_steps < 0 || n_rows < 0 || !lf_geometry_ok(G, E, nreg, block) ||
      (long long)grid * (block / G) < n)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < n_stages; ++k)
    if (plan.st[k].x >= HH && d > G * E) return (int)cudaErrorInvalidValue;
  const LfArgs a{q0, p0, qo, po, lp0, lpL, eps, im, mu, iv, P, rows, Q, Qt,
                 n, d, G, n_rows, num_steps};
  return (int)lf_dispatch(
      E, nreg, LfLaunch{a, plan, grid, block, smem, (cudaStream_t)stream});
}

// Blocks of B6 (E, nreg) resident per SM at `block` threads and `smem`
// bytes, and the kernel's registers per thread and local (spilled) bytes.
extern "C" int enf_leapfrog_occupancy(int E, int nreg, int block, int smem,
                                      int* blocks_per_sm, int* regs,
                                      int* local_bytes) {
  if (!lf_geometry_ok(1, E, nreg, block)) return (int)cudaErrorInvalidValue;
  return (int)lf_dispatch(
      E, nreg, LfQuery{block, smem, blocks_per_sm, regs, local_bytes});
}
