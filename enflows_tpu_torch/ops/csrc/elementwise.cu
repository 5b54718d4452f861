// Fused bijector-chain kernels for Hopper (sm_90a): B1 forward+ladj,
// B2 its backward, B3 the single-pass whitening loss + gradient.
//
// Replace the Pallas TPU kernels of enflows_tpu/ops/pallas/elementwise.py:
//   B1 ew_fwd_kernel<E>            <- _fused_packed_impl (_build_kernel)
//   B2 ew_grad_kernel<E, EW_BWD>   <- _fused_packed_bwd_impl
//                                     (_build_bwd_kernel)
//   B3 ew_grad_kernel<E, EW_NEGLL> <- _fused_negll_grad_impl
//                                     (_build_negll_grad_kernel)
//
// What is computed is the TPU kernels' math, not their layout: B1 gives y
// and the per-sample ladj; B3 negll's unscaled sum of logN(y) + ladj and
// every parameter cotangent for c_y = y, c_ladj = -1 (the wrapper scales by
// 1/n), writing neither y nor gx; B2 gx and the parameter cotangents from
// gy and gladj. The stage adjoints are derived by hand and follow the torch
// functions _adjoint_* of enflows_tpu_torch/ops/elementwise.py line by line
// (the CPU tests hold those against autograd, and replay this file's
// algorithm in float64).
//
// What bounds them on an H100: at small d, instruction issue. B3 reads 4 B
// per element and B1 moves 8 B per element and 4 B per sample (0.010 and
// 0.100 ms at the main path's shapes), but the flagship chain takes 18
// special functions (exp, log, log1p, sqrt, reciprocals) per element in
// B1's forward and 32 in B3's forward and adjoints, each with the
// arithmetic around it; B2/B3 recompute the forward beside the adjoints.
//
// The design:
//
// * A sample per lane group, in registers for the whole chain. G lanes
//   (a power of two <= 32) own a sample; lane l owns the E elements
//   j = c0 + l + G i (E = 1, 2 or 4, a template parameter). At d <= 4 a
//   group is one thread (G = 1, E = d rounded up to 1, 2, 4). x is read once
//   (a float2 / float4 per sample where G = 1 and d = E) and y or gx written
//   once. Without a Householder stage the elements of a sample meet only in
//   its ladj and loss sums, so a chain wider than G E (up to d = 2048) is
//   walked in column tiles of G E = 128; with one, d <= 128 is one tile.
// * No tile in shared memory and no block barrier in the grid-stride sample
//   loop. Each warp walks its 32 / G samples in step, so a group's shuffles
//   always find their lanes (a lane past n computes on the last sample and
//   adds nothing). The only barriers bracket a column tile's prologue (the
//   tile's constants) and epilogue (the block's partial sums).
// * Stage inputs for the backward: B2/B3 keep each stage's input in named
//   registers (EwSaved, switched over constants: no register array is
//   indexed at run time) for the first NREG stages, beyond that in
//   lane-private words. A stage's adjoint is given its input and its output
//   (the next stage's input), so no subexpression of the output is
//   evaluated again (CenterContract's two log1p, Johnson's asinh,
//   CenterStretch's log).
// * Per-dimension constants hoisted: a lane owns the same columns for the
//   whole tile, so each block derives once per tile every stage's
//   parameters and parameter-only subexpressions for those columns into
//   shared memory (EW_NCONST per stage and column: 1/b, 1/lambda, 1/delta,
//   ab, 4 e^{-2ab}, log|a|, log|delta/lambda|, ...). No per-element e % d,
//   no per-element parameter load from device memory, and the divisions by
//   a parameter become products.
// * Gradient sums per lane, reduced once per tile: every parameter slot's
//   sum at the lane's E columns and the Householder cotangents live in
//   lane-private words (shared memory at a stride of the block, each lane
//   touching only its own: no barrier; in a device scratch where they do
//   not fit), the loss in a register. At the end lanes owning the same
//   columns reduce with __shfl_xor_sync, warps in shared memory in a fixed
//   order, and the block writes its partials once: p_part (grid,
//   n_pslots * d), w_part (grid, n_rows * d), q_part (grid, n_dense * d *
//   d), loss_part (grid,). No atomics: deterministic for a given grid.
// * Householder stages. A stage of k reflections with 2 k <= d is applied
//   reflection by reflection from its normalized rows w_r (shared memory,
//   zero beyond d): a dot product is a lane partial plus log2(G)
//   __shfl_xor_sync steps, 4 d k FLOP. The backward walks them in reverse,
//   recovering each reflection's input from the stage's output (H_r is an
//   involution, and w.x_r = -w.x_{r+1}), and sums the row cotangent
//   -2 ((w.x_r) c + (c.w) x_r) per lane. A stage with 2 k > d (the
//   flagship's 4 reflections at d = 2), or whose rows do not fit, is its
//   dense Q (HD): x[m] broadcast by __shfl_sync, Q^T / Q read from device
//   memory (L1), the lane summing dQ[j, m] = sum c[j] x[m] for its E rows.
//   The wrapper maps both cotangents onto V by autograd.
// * Special functions as single approximate MUFU instructions in the stage
//   bodies (ex2, lg2, rcp and sqrt .approx, without .ftz: EW_FAST below),
//   log1p accurate; the constants' prologue keeps accurate libm.
//   JohnsonInv computes e^{|v|} directly, so every result is finite wherever
//   accurate f32 is. chip_smoke.py holds the kernels to the float64 plain
//   version under the unchanged gates; chip_ew_forms.py times each form
//   against accurate f32 (PERF.md).

#include <cuda_runtime.h>

#include "stages.cuh"

enum { HD = 6 };                         // a Householder stage as dense Q
enum { EW_FWD = 0, EW_BWD = 1, EW_NEGLL = 2 };

#define EW_FULL 0xffffffffu
#define EW_BLOCK_MAX 256     // threads per block at most (_EW_BLOCK)
#define EW_NCONST 6          // constants per stage and column
#define EW_MIN_BLOCKS 4      // blocks per SM: 64 registers
#define EW_MIN_BLOCKS_E4 2   // B2/B3 at E = 4: 128 registers

// Stage inputs held in registers by B2/B3, by elements per lane.
__host__ __device__ constexpr int ew_nreg(int E) {
  return E == 1 ? 8 : E == 2 ? 4 : 2;
}

// Blocks per SM each kernel is compiled for (its register budget).
constexpr int ew_min_blocks(int E, bool grad) {
  return grad && E == 4 ? EW_MIN_BLOCKS_E4 : EW_MIN_BLOCKS;
}

// The plan, one int4 per stage: (code, a, b, acc).
//   elementwise (SS..JI): a = first parameter slot, acc = a E;
//   HH (reflections):     a = first row in rows, b = k, acc = first word;
//   HD (dense):           a = index of its Q in Q and Qt, acc = first word.
struct EwPlan {
  int n_stages;
  int4 st[ENF_MAX_STAGES];
};

struct EwArgs {
  const float* x;
  const float* gy;     // B2
  const float* gladj;  // B2
  float* y;            // B1
  float* ladj;         // B1
  float* gx;           // B2
  const float* P;      // elementwise parameters, (slots, d)
  const float* rows;   // normalized reflection rows, (n_rows, d)
  const float* Q;      // dense stages' Q, (n_dense, d, d)
  const float* Qt;     // and Q^T
  float* scratch;      // lane-private words in device memory, or null
  float* loss_part;    // B3, (grid,)
  float* p_part;       // (grid, n_pslots * d)
  float* w_part;       // (grid, n_rows * d)
  float* q_part;       // (grid, n_dense * d * d)
  long long n;
  int d, G, n_pslots, n_rows, n_dense;
  int n_acc;           // accumulator words per lane
  int packed;          // G = 1, d = E and rows aligned to E floats
};

// ---------------------------------------------------------------------------
// Per-tile constants: row 6 k + c of cst holds stage k's constant c for each
// of the tile's DC columns (c0 + col, clamped to d - 1 beyond d).
//   SS: a, b, log|a|, 1/a
//   CC: a, b, c, 1/b
//   CS: b, c, ab, 1/b, 4 e^{-2ab}, a
//   JF: gamma, delta, xi, 1/lambda, 1/delta, log|delta/lambda|
//   JI: gamma, 1/delta, lambda, xi, 1/lambda, log|lambda/delta|
__device__ __forceinline__ void ew_consts(float* cst, const int4* st, int nst,
                                          const float* __restrict__ P, int d,
                                          int c0, int DC) {
  for (int col = threadIdx.x; col < DC; col += blockDim.x) {
    const int j = min(c0 + col, d - 1);
    for (int k = 0; k < nst; ++k) {
      const int code = st[k].x, s = st[k].y;
      float* kc = cst + EW_NCONST * k * DC + col;
      if (code == SS) {
        const float av = par(P, s, d, j);
        kc[0] = av;
        kc[DC] = par(P, s + 1, d, j);
        kc[2 * DC] = logf(fabsf(av));
        kc[3 * DC] = 1.f / av;
      } else if (code == CC) {
        const float b = par(P, s + 1, d, j);
        kc[0] = par(P, s, d, j);
        kc[DC] = b;
        kc[2 * DC] = par(P, s + 2, d, j);
        kc[3 * DC] = 1.f / b;
      } else if (code == CS) {
        const float av = par(P, s, d, j), b = par(P, s + 1, d, j);
        const float ab = av * b;
        kc[0] = b;
        kc[DC] = par(P, s + 2, d, j);
        kc[2 * DC] = ab;
        kc[3 * DC] = 1.f / b;
        kc[4 * DC] = 4.f * expf(-2.f * ab);
        kc[5 * DC] = av;
      } else if (code == JF) {
        const float delta = par(P, s + 1, d, j), lam = par(P, s + 3, d, j);
        kc[0] = par(P, s, d, j);
        kc[DC] = delta;
        kc[2 * DC] = par(P, s + 2, d, j);
        kc[3 * DC] = 1.f / lam;
        kc[4 * DC] = 1.f / delta;
        kc[5 * DC] = logf(fabsf(delta / lam));
      } else if (code == JI) {
        const float delta = par(P, s + 1, d, j), lam = par(P, s + 3, d, j);
        kc[0] = par(P, s, d, j);
        kc[DC] = 1.f / delta;
        kc[2 * DC] = lam;
        kc[3 * DC] = par(P, s + 2, d, j);
        kc[4 * DC] = 1.f / lam;
        kc[5 * DC] = logf(fabsf(lam / delta));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The special functions of the stage bodies. EW_FAST selects approximate
// single-instruction forms (bit 0: exp as ex2.approx, 1: log as lg2.approx,
// 2: reciprocals and divisions by rcp.approx, 3: sqrt.approx), all without
// .ftz, so subnormal arguments and results stay as accurate f32 has them;
// log1p stays accurate. 0 is accurate f32 libm throughout. All four are
// kept (15): on an H100 they took B3 at d=2, n=2^22 from 0.441 to 0.347 ms
// and B1 at d=2, n=2^24 from 0.693 to 0.474 ms (chip_ew_forms.py).
#ifndef EW_FAST
#define EW_FAST 15
#endif

__device__ __forceinline__ float ew_exp(float v) {
#if EW_FAST & 1
  float r;
  asm("ex2.approx.f32 %0, %1;" : "=f"(r) : "f"(v * 1.44269504088896341f));
  return r;
#else
  return expf(v);
#endif
}

__device__ __forceinline__ float ew_log(float v) {
#if EW_FAST & 2
  float r;
  asm("lg2.approx.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r * ENF_LOG2;
#else
  return logf(v);
#endif
}

__device__ __forceinline__ float ew_rcp(float v) {
#if EW_FAST & 4
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
#else
  return 1.f / v;
#endif
}

__device__ __forceinline__ float ew_div(float a, float b) {
#if EW_FAST & 4
  return a * ew_rcp(b);
#else
  return a / b;
#endif
}

__device__ __forceinline__ float ew_sqrt(float v) {
#if EW_FAST & 8
  float r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
#else
  return sqrtf(v);
#endif
}

// ---------------------------------------------------------------------------
// One elementwise stage at one element, k = its first constant at the
// element's column (constant c at k[c * DC]). Forward: returns y, writes
// the ladj term. Backward: returns the input cotangent ct for the output
// cotangent cy and the ladj term's ce, given the stage's input t and its
// output y (the next stage's saved input: no subexpression of y is
// recomputed), and writes the parameter terms into g.

__device__ __forceinline__ float f_ss(float t, const float* k, int DC,
                                      float& el) {
  el = k[2 * DC];
  return t * k[0] + k[DC];
}

__device__ __forceinline__ float b_ss(float t, float, float cy, float ce,
                                      const float* k, int DC, float* g) {
  g[0] = cy * t + ce * k[3 * DC];
  g[1] = cy;
  return cy * k[0];
}

__device__ __forceinline__ float f_cc(float t, const float* k, int DC,
                                      float& el) {
  const float a = k[0], b = k[DC];
  const float xu = t - k[2 * DC];
  const float u1 = b * (xu - a), u2 = b * (xu + a);
  const float e1 = ew_exp(-fabsf(u1)), e2 = ew_exp(-fabsf(u2));
  const float r1 = ew_rcp(1.f + e1), r2 = ew_rcp(1.f + e2);
  const float s1 = (u1 >= 0.f ? 1.f : e1) * r1;
  const float s2 = (-u2 >= 0.f ? 1.f : e2) * r2;
  el = ew_log(s1 + s2);
  // softplus(u1) - softplus(-u2) through one log1p:
  // log1p(e1) - log1p(e2) = log1p((e1 - e2) / (1 + e2)).
  return (fmaxf(u1, 0.f) - fmaxf(-u2, 0.f) + log1pf((e1 - e2) * r2)) *
         k[3 * DC];
}

__device__ __forceinline__ float b_cc(float t, float y, float cy, float ce,
                                      const float* k, int DC, float* g) {
  const float a = k[0], b = k[DC], ib = k[3 * DC];
  const float xu = t - k[2 * DC];
  const float xm = xu - a, xp = xu + a;
  const float u1 = b * xm, u2 = b * xp;
  const float e1 = ew_exp(-fabsf(u1)), e2 = ew_exp(-fabsf(u2));
  const float r1 = ew_rcp(1.f + e1), r2 = ew_rcp(1.f + e2);
  const float s1 = (u1 >= 0.f ? 1.f : e1) * r1;
  const float s2 = (-u2 >= 0.f ? 1.f : e2) * r2;
  const float p1 = e1 * r1 * r1, p2 = e2 * r2 * r2;
  const float S = s1 + s2;
  const float iS = ew_rcp(S);
  const float ct = cy * S + ce * b * (p1 - p2) * iS;
  g[0] = cy * (s2 - s1) - ce * b * (p1 + p2) * iS;
  g[1] = cy * (s1 * xm + s2 * xp - y) * ib + ce * (p1 * xm - p2 * xp) * iS;
  g[2] = -ct;
  return ct;
}

// CenterStretch's shared intermediates at t (stage_fwd's CS branch):
// m = max(|b t|, 1e-6), e^{-m} and denom = 1 - e^{-m} + r.
struct CsTerms {
  float m, em, denom;
};

__device__ __forceinline__ CsTerms cs_terms(float t, const float* k,
                                            int DC) {
  CsTerms r;
  r.m = fmaxf(fabsf(k[0] * t), 1e-6f);
  r.em = ew_exp(-r.m);
  const float one_m = 1.f - r.em;
  r.denom = one_m + ew_sqrt(one_m * one_m + k[4 * DC] * r.em);
  return r;
}

__device__ __forceinline__ float f_cs(float t, const float* k, int DC,
                                      float& el) {
  const CsTerms r = cs_terms(t, k, DC);
  const float log_s = r.m + k[2 * DC] - ENF_LOG2 + ew_log(r.denom);
  // s_sum = 1/(1 + ae) + q/(1 + q), q = ae e^{-2ab}: the contract's
  // sigmoids at y, as stage_bwd writes them.
  const float ae = ew_div(2.f * r.em, r.denom);
  const float q = 0.25f * ae * k[4 * DC];
  el = -ew_log(ew_rcp(1.f + ae) + ew_div(q, 1.f + q));
  return k[DC] + sgnf(t) * log_s * k[3 * DC];
}

__device__ __forceinline__ float b_cs(float t, float y, float cy, float ce,
                                      const float* k, int DC, float* g) {
  const float b = k[0], ib = k[3 * DC], a = k[5 * DC];
  const CsTerms r = cs_terms(t, k, DC);
  const float sg = sgnf(t);
  const float yu = y - k[DC];
  const float ae = ew_div(2.f * r.em, r.denom);
  const float q = 0.25f * ae * k[4 * DC];
  const float A = ew_rcp(1.f + ae), rq = ew_rcp(1.f + q);
  const float B = q * rq;
  const float pA = A * A * ae, pB = B * rq;
  const float s1 = sg >= 0.f ? A : B, s2 = sg >= 0.f ? B : A;
  const float p1 = sg >= 0.f ? pA : pB, p2 = sg >= 0.f ? pB : pA;
  const float S = s1 + s2;
  const float iS = ew_rcp(S);
  const float Sy = b * (p1 - p2);
  const float dy_da = (s1 - s2) * iS;
  const float dy_db = -(s1 * (yu - a) + s2 * (yu + a) - t) * ib * iS;
  const float dE_dt = -Sy * iS * iS;
  const float dE_da = -(Sy * dy_da - b * (p1 + p2)) * iS;
  const float dE_db = -(Sy * dy_db + p1 * (yu - a) - p2 * (yu + a)) * iS;
  g[0] = cy * dy_da + ce * dE_da;
  g[1] = cy * dy_db + ce * dE_db;
  g[2] = cy;
  return cy * iS + ce * dE_dt;
}

__device__ __forceinline__ float f_jf(float t, const float* k, int DC,
                                      float& el) {
  const float u = (t - k[2 * DC]) * k[3 * DC];
  const float s = ew_sqrt(1.f + u * u);
  el = k[5 * DC] - ew_log(s);
  return k[0] + k[DC] * (sgnf(u) * ew_log(fabsf(u) + s));
}

__device__ __forceinline__ float b_jf(float t, float y, float cy, float ce,
                                      const float* k, int DC, float* g) {
  const float delta = k[DC], il = k[3 * DC], id = k[4 * DC];
  const float u = (t - k[2 * DC]) * il;
  const float s = ew_sqrt(1.f + u * u);
  const float is = ew_rcp(s);
  const float cu = cy * delta * is - ce * u * is * is;
  const float ct = cu * il;
  g[0] = cy;
  g[1] = cy * ((y - k[0]) * id) + ce * id;
  g[2] = -ct;
  g[3] = -(cu * u + ce) * il;
  return ct;
}

__device__ __forceinline__ float f_ji(float t, const float* k, int DC,
                                      float& el) {
  const float v = (t - k[0]) * k[DC];
  const float av = fabsf(v);
  const float ei = ew_exp(-av), e = ew_exp(av);
  el = k[5 * DC] + av + log1pf(ei * ei) - ENF_LOG2;
  return k[2 * DC] * (sgnf(v) * 0.5f * (e - ei)) + k[3 * DC];
}

__device__ __forceinline__ float b_ji(float t, float, float cy, float ce,
                                      const float* k, int DC, float* g) {
  const float id = k[DC];
  const float v = (t - k[0]) * id;
  const float ei = ew_exp(-fabsf(v)), e = ew_exp(fabsf(v));
  const float sg = sgnf(v);
  const float ei2 = ei * ei;
  const float sinh_v = sg * 0.5f * (e - ei);
  const float cosh_v = 0.5f * (e + ei);
  const float tanh_v = ew_div(sg * (1.f - ei2), 1.f + ei2);
  const float cv = cy * k[2 * DC] * cosh_v + ce * tanh_v;
  const float ct = cv * id;
  g[0] = -ct;
  g[1] = -(cv * v + ce) * id;
  g[2] = cy;
  g[3] = cy * sinh_v + ce * k[4 * DC];
  return ct;
}

// ---------------------------------------------------------------------------
// A stage at the lane's E elements. kc: the stage's first constant at the
// lane's first column (element i at kc + G i). With LADJ the ladj terms of
// the valid elements (bit i of vm) are added to ls.

template <int E, bool LADJ>
__device__ __forceinline__ void ew_fwd(int code, float (&x)[E], float& ls,
                                       int vm, const float* kc, int DC,
                                       int G) {
  float el[E];
  switch (code) {
    case SS:
#pragma unroll
      for (int i = 0; i < E; ++i) x[i] = f_ss(x[i], kc + G * i, DC, el[i]);
      break;
    case CC:
#pragma unroll
      for (int i = 0; i < E; ++i) x[i] = f_cc(x[i], kc + G * i, DC, el[i]);
      break;
    case CS:
#pragma unroll
      for (int i = 0; i < E; ++i) x[i] = f_cs(x[i], kc + G * i, DC, el[i]);
      break;
    case JF:
#pragma unroll
      for (int i = 0; i < E; ++i) x[i] = f_jf(x[i], kc + G * i, DC, el[i]);
      break;
    default:
#pragma unroll
      for (int i = 0; i < E; ++i) x[i] = f_ji(x[i], kc + G * i, DC, el[i]);
  }
  if (LADJ) {
#pragma unroll
    for (int i = 0; i < E; ++i)
      if (vm >> i & 1) ls += el[i];
  }
}

// acc word (a0 + q E + i) += g[i][q], q < NP: the lane's sums of parameter
// slot a0 / E + q at its E columns.
template <int E, int NP>
__device__ __forceinline__ void ew_acc(float* acc, int a0, int ps,
                                       const float (&g)[E][4], bool live) {
  if (!live) return;
#pragma unroll
  for (int q = 0; q < NP; ++q)
#pragma unroll
    for (int i = 0; i < E; ++i) acc[(size_t)(a0 + q * E + i) * ps] += g[i][q];
}

template <int E>
__device__ __forceinline__ void ew_bwd(int code, const float (&t)[E],
                                       const float (&y)[E], float (&c)[E],
                                       float ce,
                                       const float* kc, int DC, int G,
                                       float* acc, int a0, int ps,
                                       bool live) {
  float g[E][4];
  switch (code) {
    case SS:
#pragma unroll
      for (int i = 0; i < E; ++i)
        c[i] = b_ss(t[i], y[i], c[i], ce, kc + G * i, DC, g[i]);
      ew_acc<E, 2>(acc, a0, ps, g, live);
      break;
    case CC:
#pragma unroll
      for (int i = 0; i < E; ++i)
        c[i] = b_cc(t[i], y[i], c[i], ce, kc + G * i, DC, g[i]);
      ew_acc<E, 3>(acc, a0, ps, g, live);
      break;
    case CS:
#pragma unroll
      for (int i = 0; i < E; ++i)
        c[i] = b_cs(t[i], y[i], c[i], ce, kc + G * i, DC, g[i]);
      ew_acc<E, 3>(acc, a0, ps, g, live);
      break;
    case JF:
#pragma unroll
      for (int i = 0; i < E; ++i)
        c[i] = b_jf(t[i], y[i], c[i], ce, kc + G * i, DC, g[i]);
      ew_acc<E, 4>(acc, a0, ps, g, live);
      break;
    default:
#pragma unroll
      for (int i = 0; i < E; ++i)
        c[i] = b_ji(t[i], y[i], c[i], ce, kc + G * i, DC, g[i]);
      ew_acc<E, 4>(acc, a0, ps, g, live);
  }
}

// ---------------------------------------------------------------------------
// Householder stages.

// The sum of v over the lane group: every lane of the group gets it.
__device__ __forceinline__ float ew_group_sum(float v, int G) {
  for (int off = 1; off < G; off <<= 1) v += __shfl_xor_sync(EW_FULL, v, off);
  return v;
}

// k reflections x <- x - 2 (w_r . x) w_r, r = 0..k-1; w: the first row in
// shared memory at the lane's first column (rows of DC floats, zero beyond
// d).
template <int E>
__device__ __forceinline__ void ew_reflect(float (&x)[E], const float* w,
                                           int k, int DC, int G) {
  for (int r = 0; r < k; ++r) {
    const float* row = w + r * DC;
    float wv[E];
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      wv[i] = row[G * i];
      dot = fmaf(wv[i], x[i], dot);
    }
    const float m2 = -2.f * ew_group_sum(dot, G);
#pragma unroll
    for (int i = 0; i < E; ++i) x[i] = fmaf(m2, wv[i], x[i]);
  }
}

// The adjoint of ew_reflect. z: the stage's output on entry (overwritten);
// c: the cotangent of the output, the input's on return. For r = k-1..0:
// z becomes reflection r's input x_r = H_r z, whose w . x_r = -(w . z); the
// row's cotangent -2 ((w . x_r) c + (c . w) x_r) is summed into the words
// a0 + r E + i; c <- c - 2 (c . w) w.
template <int E>
__device__ __forceinline__ void ew_reflect_bwd(float (&z)[E], float (&c)[E],
                                               const float* w, int k, int DC,
                                               int G, float* acc, int a0,
                                               int ps, bool live) {
  for (int r = k - 1; r >= 0; --r) {
    const float* row = w + r * DC;
    float wv[E];
    float dz = 0.f, dc = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      wv[i] = row[G * i];
      dz = fmaf(wv[i], z[i], dz);
      dc = fmaf(wv[i], c[i], dc);
    }
    dz = ew_group_sum(dz, G);
    dc = ew_group_sum(dc, G);
#pragma unroll
    for (int i = 0; i < E; ++i) {
      z[i] = fmaf(-2.f * dz, wv[i], z[i]);
      if (live)
        acc[(size_t)(a0 + r * E + i) * ps] += -2.f * (-dz * c[i] + dc * z[i]);
      c[i] = fmaf(-2.f * dc, wv[i], c[i]);
    }
  }
}

// x <- x M, M (d, d) row-major in device memory (M = Q^T forward, Q for the
// adjoint): x[m] broadcast to the group by __shfl_sync, the lanes reading a
// row of M at consecutive columns; pad elements (j >= d) stay 0.
template <int E>
__device__ __forceinline__ void ew_dense(float (&x)[E],
                                         const float* __restrict__ M, int d,
                                         int G, int lig) {
  float y[E];
#pragma unroll
  for (int i = 0; i < E; ++i) y[i] = 0.f;
#pragma unroll
  for (int i2 = 0; i2 < E; ++i2) {
    for (int l = 0; l < G; ++l) {
      const int m = l + G * i2;
      const float xm = __shfl_sync(EW_FULL, x[i2], l, G);
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

// dQ[j, m] += c[j] t[m] for the lane's rows j = lig + G i, into the words
// a0 + i d + m.
template <int E>
__device__ __forceinline__ void ew_dense_grad(const float (&t)[E],
                                              const float (&c)[E], int d,
                                              int G, int lig, float* acc,
                                              int a0, int ps, bool live) {
#pragma unroll
  for (int i2 = 0; i2 < E; ++i2) {
    for (int l = 0; l < G; ++l) {
      const int m = l + G * i2;
      const float tm = __shfl_sync(EW_FULL, t[i2], l, G);
      if (m < d && live) {
#pragma unroll
        for (int i = 0; i < E; ++i)
          if (lig + G * i < d)
            acc[(size_t)(a0 + i * d + m) * ps] =
                fmaf(c[i], tm, acc[(size_t)(a0 + i * d + m) * ps]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Stage inputs kept for the backward: slots below NREG in registers (indexed
// by unrolled constants only), the rest in lane-private words at `spill`.
template <int E, int NREG>
struct EwSaved {
  float r[NREG][E];

  __device__ __forceinline__ void save(int k, const float (&x)[E],
                                       float* spill, int ps) {
    if (k < NREG) {
#pragma unroll
      for (int s = 0; s < NREG; ++s)
        if (s == k) {
#pragma unroll
          for (int i = 0; i < E; ++i) r[s][i] = x[i];
        }
    } else {
      float* w = spill + (size_t)(k - NREG) * E * ps;
#pragma unroll
      for (int i = 0; i < E; ++i) w[(size_t)i * ps] = x[i];
    }
  }

  __device__ __forceinline__ void load(int k, float (&x)[E],
                                       const float* spill, int ps) const {
    if (k < NREG) {
#pragma unroll
      for (int s = 0; s < NREG; ++s)
        if (s == k) {
#pragma unroll
          for (int i = 0; i < E; ++i) x[i] = r[s][i];
        }
    } else {
      const float* w = spill + (size_t)(k - NREG) * E * ps;
#pragma unroll
      for (int i = 0; i < E; ++i) x[i] = w[(size_t)i * ps];
    }
  }
};

// The lane's E elements of row p (p at the lane's first column): a float2
// or float4 where `packed`, else the valid ones (bit i of vm), 0 beyond.
template <int E>
__device__ __forceinline__ void ew_load(float (&x)[E],
                                        const float* __restrict__ p, int G,
                                        int vm, bool packed) {
  if constexpr (E == 2) {
    if (packed) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(p));
      x[0] = v.x;
      x[1] = v.y;
      return;
    }
  }
  if constexpr (E == 4) {
    if (packed) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p));
      x[0] = v.x;
      x[1] = v.y;
      x[2] = v.z;
      x[3] = v.w;
      return;
    }
  }
  {
#pragma unroll
    for (int i = 0; i < E; ++i) x[i] = vm >> i & 1 ? __ldg(p + G * i) : 0.f;
  }
}

template <int E>
__device__ __forceinline__ void ew_store(float* p, const float (&x)[E],
                                         int G, int vm, bool packed) {
  if constexpr (E == 2) {
    if (packed) {
      *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
      return;
    }
  }
  if constexpr (E == 4) {
    if (packed) {
      *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
      return;
    }
  }
  {
#pragma unroll
    for (int i = 0; i < E; ++i)
      if (vm >> i & 1) p[G * i] = x[i];
  }
}

// The block's prologue, shared by the kernels: the plan and the reflection
// rows into shared memory. Returns the tile's constant table.
struct EwShared {
  int4* st;
  float* cst;
  float* rows;
  float* red;    // 32 floats for the loss reduction
  float* priv;   // lane-private words when they live in shared memory
};

__device__ __forceinline__ EwShared ew_prologue(int4* smem, const EwArgs& a,
                                                const EwPlan& plan, int DC) {
  const int nst = plan.n_stages;
  EwShared sh;
  sh.st = smem;
  sh.cst = reinterpret_cast<float*>(smem + nst);
  sh.rows = sh.cst + EW_NCONST * nst * DC;
  sh.red = sh.rows + a.n_rows * DC;
  sh.priv = sh.red + 32;
  for (int k = threadIdx.x; k < nst; k += blockDim.x) sh.st[k] = plan.st[k];
  for (int e = threadIdx.x; e < a.n_rows * DC; e += blockDim.x) {
    const int r = e / DC, col = e - r * DC;
    sh.rows[e] = col < a.d ? __ldg(a.rows + (size_t)r * a.d + col) : 0.f;
  }
  return sh;
}

// One stage of the forward: elementwise, reflections or dense.
template <int E, bool LADJ>
__device__ __forceinline__ void ew_stage(const int4 w, int k, float (&x)[E],
                                         float& ls, int vm,
                                         const EwShared& sh, const EwArgs& a,
                                         int DC, int G, int lig) {
  if (w.x < HH)
    ew_fwd<E, LADJ>(w.x, x, ls, vm, sh.cst + EW_NCONST * k * DC + lig, DC,
                    G);
  else if (w.x == HH)
    ew_reflect<E>(x, sh.rows + w.y * DC + lig, w.z, DC, G);
  else
    ew_dense<E>(x, a.Qt + (size_t)w.y * a.d * a.d, a.d, G, lig);
}

// ---------------------------------------------------------------------------
// B1: replaces _fused_packed_impl (ops/pallas/elementwise.py:441-507).
// Bound: x read and y written once (8 B per element, 4 B per sample of
// ladj), and the stage bodies' special functions. Each warp walks its
// samples in step; a group's ladj is a lane partial plus log2(G) shuffles,
// added over the column tiles by the lane that writes it.
template <int E>
__global__ void __launch_bounds__(EW_BLOCK_MAX, ew_min_blocks(E, false))
    ew_fwd_kernel(const EwArgs a, const EwPlan plan) {
  extern __shared__ int4 smem[];
  const int G = a.G, DC = G * E, d = a.d, nst = plan.n_stages;
  const EwShared sh = ew_prologue(smem, a, plan, DC);
  const int lig = threadIdx.x & (G - 1), lane = threadIdx.x & 31;
  const long long gstride = (long long)gridDim.x * blockDim.x / G;
  const long long g0 =
      ((long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31)) / G;
  const bool packed = a.packed;
  for (int c0 = 0; c0 < d; c0 += DC) {
    __syncthreads();  // the previous tile's constants are read
    ew_consts(sh.cst, sh.st, nst, a.P, d, c0, DC);
    __syncthreads();
    int vm = 0;
#pragma unroll
    for (int i = 0; i < E; ++i) vm |= (c0 + lig + G * i < d) << i;
    for (long long s0 = g0; s0 < a.n; s0 += gstride) {
      const long long s = s0 + lane / G;
      const bool live = s < a.n;
      const long long cs = live ? s : a.n - 1;
      float x[E];
      ew_load<E>(x, a.x + cs * d + c0 + lig, G, vm, packed);
      float ls = 0.f;
      for (int k = 0; k < nst; ++k)
        ew_stage<E, true>(sh.st[k], k, x, ls, vm, sh, a, DC, G, lig);
      ls = ew_group_sum(ls, G);
      if (live) {
        ew_store<E>(a.y + s * d + c0 + lig, x, G, vm, packed);
        if (lig == 0) a.ladj[s] = c0 == 0 ? ls : a.ladj[s] + ls;
      }
    }
  }
}

// The block's sum of word w at group lane l, written to its output.
__device__ __forceinline__ void ew_write(const EwArgs& a, const int4* st,
                                         int nst, int E, int G, int c0, int w,
                                         int l, float v) {
  const int d = a.d;
  const size_t blk = blockIdx.x;
  if (w < a.n_pslots * E) {
    const int q = w / E, i = w - q * E, j = c0 + l + G * i;
    if (j < d) a.p_part[(blk * a.n_pslots + q) * d + j] = v;
    return;
  }
  for (int k = 0; k < nst; ++k) {
    const int4 s = st[k];
    if (s.x < HH || w < s.w) continue;
    const int o = w - s.w;
    if (s.x == HH && o < s.z * E) {
      const int r = o / E, j = l + G * (o - r * E);
      if (j < d) a.w_part[(blk * a.n_rows + s.y + r) * d + j] = v;
      return;
    }
    if (s.x == HD && o < E * d) {
      const int i = o / d, m = o - i * d, j = l + G * i;
      if (j < d) a.q_part[((blk * a.n_dense + s.y) * d + j) * d + m] = v;
      return;
    }
  }
}

// B2 (MODE = EW_BWD): replaces _fused_packed_bwd_impl
// (ops/pallas/elementwise.py:641-743). Bound: x and gy read, gx written
// (12 B per element, 4 B per sample of gladj), the forward recomputed and
// the adjoints. B3 (MODE = EW_NEGLL): replaces _fused_negll_grad_impl
// (ops/pallas/elementwise.py:852-906). Bound: x read once (4 B per
// element), the forward and adjoint arithmetic. See the header.
template <int E, int MODE>
__global__ void __launch_bounds__(EW_BLOCK_MAX, ew_min_blocks(E, true))
    ew_grad_kernel(const EwArgs a, const EwPlan plan) {
  constexpr int NREG = ew_nreg(E);
  constexpr bool NEGLL = MODE == EW_NEGLL;
  extern __shared__ int4 smem[];
  const int G = a.G, DC = G * E, d = a.d, nst = plan.n_stages;
  const EwShared sh = ew_prologue(smem, a, plan, DC);
  const int lig = threadIdx.x & (G - 1), lane = threadIdx.x & 31;
  const long long gstride = (long long)gridDim.x * blockDim.x / G;
  const long long g0 =
      ((long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31)) / G;
  const bool packed = a.packed;
  // Lane-private words: word w of lane t at priv[w * ps + t].
  float* priv = a.scratch ? a.scratch + (size_t)blockIdx.x * blockDim.x
                          : sh.priv;
  const int ps = a.scratch ? gridDim.x * blockDim.x : blockDim.x;
  float* mine = priv + threadIdx.x;
  float* spill = mine + (size_t)a.n_acc * ps;
  float loss = 0.f;

  for (int c0 = 0; c0 < d; c0 += DC) {
    __syncthreads();  // the previous tile's constants and sums are read
    ew_consts(sh.cst, sh.st, nst, a.P, d, c0, DC);
    for (int w = 0; w < a.n_acc; ++w) mine[(size_t)w * ps] = 0.f;
    __syncthreads();
    int vm = 0;
#pragma unroll
    for (int i = 0; i < E; ++i) vm |= (c0 + lig + G * i < d) << i;

    for (long long s0 = g0; s0 < a.n; s0 += gstride) {
      const long long s = s0 + lane / G;
      const bool live = s < a.n;
      const long long cs = live ? s : a.n - 1;
      float x[E];
      ew_load<E>(x, a.x + cs * d + c0 + lig, G, vm, packed);
      EwSaved<E, NREG> sv;
      float ls = 0.f;
      for (int k = 0; k < nst; ++k) {
        sv.save(k, x, spill, ps);
        ew_stage<E, NEGLL>(sh.st[k], k, x, ls, vm, sh, a, DC, G, lig);
      }
      // The output cotangents: B3 c_y = y, c_ladj = -1; B2 gy, gladj.
      float c[E], ce;
      if (NEGLL) {
#pragma unroll
        for (int i = 0; i < E; ++i) {
          if (vm >> i & 1) ls += -0.5f * (x[i] * x[i] + ENF_LOG_2PI);
          c[i] = x[i];
        }
        ce = -1.f;
        if (live) loss += ls;
      } else {
        ew_load<E>(c, a.gy + cs * d + c0 + lig, G, vm, packed);
        ce = __ldg(a.gladj + cs);
      }
      // The reverse sweep; x holds stage k's output (the chain's output,
      // then each stage's saved input).
      for (int k = nst - 1; k >= 0; --k) {
        const int4 w = sh.st[k];
        float t[E];
        sv.load(k, t, spill, ps);
        if (w.x < HH) {
          ew_bwd<E>(w.x, t, x, c, ce, sh.cst + EW_NCONST * k * DC + lig, DC,
                    G, mine, w.w, ps, live);
        } else if (w.x == HH) {
          ew_reflect_bwd<E>(x, c, sh.rows + w.y * DC + lig, w.z, DC, G, mine,
                            w.w, ps, live);
        } else {
          ew_dense_grad<E>(t, c, d, G, lig, mine, w.w, ps, live);
          ew_dense<E>(c, a.Q + (size_t)w.y * d * d, d, G, lig);
        }
#pragma unroll
        for (int i = 0; i < E; ++i) x[i] = t[i];
      }
      if (!NEGLL && live) ew_store<E>(a.gx + s * d + c0 + lig, c, G, vm,
                                      packed);
    }

    // The tile's epilogue: groups of a warp, then warps in order.
    for (int w = 0; w < a.n_acc; ++w) {
      float v = mine[(size_t)w * ps];
      for (int off = G; off < 32; off <<= 1)
        v += __shfl_xor_sync(EW_FULL, v, off);
      mine[(size_t)w * ps] = v;
    }
    __syncthreads();
    const int nwarps = blockDim.x >> 5;
    for (int idx = threadIdx.x; idx < a.n_acc * G; idx += blockDim.x) {
      const int w = idx / G, l = idx - w * G;
      float v = 0.f;
      for (int q = 0; q < nwarps; ++q) v += priv[(size_t)w * ps + 32 * q + l];
      ew_write(a, sh.st, nst, E, G, c0, w, l, v);
    }
  }
  if (NEGLL) {
    for (int off = 16; off > 0; off >>= 1)
      loss += __shfl_xor_sync(EW_FULL, loss, off);
    if (lane == 0) sh.red[threadIdx.x >> 5] = loss;
    __syncthreads();
    if (threadIdx.x == 0) {
      float sum = 0.f;
      for (int q = 0; q < (int)(blockDim.x >> 5); ++q) sum += sh.red[q];
      a.loss_part[blockIdx.x] = sum;
    }
  }
}

// ---------------------------------------------------------------------------
// Launch and occupancy, by (mode, E).

struct EwLaunch {
  const EwArgs& a;
  const EwPlan& plan;
  int grid, block, smem;
  cudaStream_t stream;
  template <typename K>
  cudaError_t run(K kernel) const {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, block, smem, stream>>>(a, plan);
    return cudaGetLastError();
  }
};

struct EwQuery {
  int block, smem;
  int *blocks_per_sm, *regs, *local_bytes;
  template <typename K>
  cudaError_t run(K kernel) const {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    *regs = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm,
                                                         kernel, block, smem);
  }
};

template <typename F>
static cudaError_t ew_dispatch(int mode, int E, const F& f) {
  switch (mode * 8 + E) {
    case EW_FWD * 8 + 1: return f.run(ew_fwd_kernel<1>);
    case EW_FWD * 8 + 2: return f.run(ew_fwd_kernel<2>);
    case EW_FWD * 8 + 4: return f.run(ew_fwd_kernel<4>);
    case EW_BWD * 8 + 1: return f.run(ew_grad_kernel<1, EW_BWD>);
    case EW_BWD * 8 + 2: return f.run(ew_grad_kernel<2, EW_BWD>);
    case EW_BWD * 8 + 4: return f.run(ew_grad_kernel<4, EW_BWD>);
    case EW_NEGLL * 8 + 1: return f.run(ew_grad_kernel<1, EW_NEGLL>);
    case EW_NEGLL * 8 + 2: return f.run(ew_grad_kernel<2, EW_NEGLL>);
    case EW_NEGLL * 8 + 4: return f.run(ew_grad_kernel<4, EW_NEGLL>);
  }
  return cudaErrorInvalidValue;
}

static bool ew_geometry_ok(int mode, int G, int E, int block) {
  return mode >= EW_FWD && mode <= EW_NEGLL && G >= 1 && G <= 32 &&
         (G & (G - 1)) == 0 && (E == 1 || E == 2 || E == 4) &&
         block >= 32 && block <= EW_BLOCK_MAX && block % 32 == 0;
}

// C interface. enf_error_string: CUDA's text for an error code.
extern "C" const char* enf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launches B1 (mode 0), B2 (1) or B3 (2) on `stream`; does not synchronize;
// returns cudaGetLastError() after the launch (0 on success). words: 4 ints
// per stage (EwPlan); G lanes per sample, E elements per lane; n_acc
// accumulator words per lane; scratch: the lane-private words in device
// memory (grid * block * words floats), or null for shared memory. The
// wrapper's chain_geometry gives the rest.
extern "C" int enf_fused_chain(
    int mode, const float* x, const float* gy, const float* gladj, float* y,
    float* ladj, float* gx, const float* P, const float* rows,
    const float* Q, const float* Qt, float* scratch, float* loss_part,
    float* p_part, float* w_part, float* q_part, const int* words,
    int n_stages, long long n, int d, int G, int E, int n_pslots, int n_rows,
    int n_dense, int n_acc, int packed, int grid, int block, int smem,
    void* stream) {
  if (n_stages < 0 || n_stages > ENF_MAX_STAGES || n <= 0 || d <= 0 ||
      grid <= 0 || !ew_geometry_ok(mode, G, E, block))
    return (int)cudaErrorInvalidValue;
  EwPlan plan;
  plan.n_stages = n_stages;
  for (int k = 0; k < ENF_MAX_STAGES; ++k) {
    plan.st[k] = k < n_stages ? make_int4(words[4 * k], words[4 * k + 1],
                                          words[4 * k + 2], words[4 * k + 3])
                              : make_int4(0, 0, 0, 0);
    if (k < n_stages &&
        (plan.st[k].x < SS || plan.st[k].x > HD ||
         (plan.st[k].x >= HH && d > G * E)))
      return (int)cudaErrorInvalidValue;
  }
  if (packed && !(G == 1 && d == E)) return (int)cudaErrorInvalidValue;
  const EwArgs a{x, gy, gladj, y, ladj, gx, P, rows, Q, Qt, scratch,
                 loss_part, p_part, w_part, q_part, n, d, G, n_pslots,
                 n_rows, n_dense, n_acc, packed};
  return (int)ew_dispatch(
      mode, E, EwLaunch{a, plan, grid, block, smem, (cudaStream_t)stream});
}

// Blocks of (mode, E) resident per SM at `block` threads and `smem` bytes,
// and the kernel's registers per thread and local (spilled) bytes.
extern "C" int enf_chain_occupancy(int mode, int E, int block, int smem,
                                   int* blocks_per_sm, int* regs,
                                   int* local_bytes) {
  if (!ew_geometry_ok(mode, 1, E, block)) return (int)cudaErrorInvalidValue;
  return (int)ew_dispatch(
      mode, E, EwQuery{block, smem, blocks_per_sm, regs, local_bytes});
}
