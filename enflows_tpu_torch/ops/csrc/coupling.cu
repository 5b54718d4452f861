// Fused coupling-stack kernels for Hopper (sm_90a): B4 forward+ladj of a
// whole coupling stack, B5 its backward (a per-tile sweep and a batch
// reduction of the conditioner weight gradients).
//
// Replace the Pallas TPU kernels of enflows_tpu/ops/pallas/coupling.py:
//   B4 coupling_fwd_kernel  <- _fused_coupling_impl (:677-716; kernel
//      _build_coupling_kernel :517, body _tile_apply :451, spline epilogue
//      _spline_slab_epilogue :322)
//   B5 coupling_bwd_kernel + coupling_dw_kernel <- _fused_coupling_bwd_impl
//      (:616-674; kernel _build_coupling_bwd_kernel :595)
//
// The stack arrives as a plan built by enflows_tpu_torch/ops/coupling.py
// (``_stack_structure``, ``_stack_plan``): per stage its kind (affine,
// spline or elementwise), the physical half that conditions, the flags, the
// activation and its conditioner layers; per layer (K, N) and the offsets of
// its W (K, N) row-major followed by its bias (N) in one flat f32 buffer,
// Permutes already absorbed into the first-layer rows and last-layer
// columns. The state of a sample stays in physical lane order as two halves
// [0, d/2) and [d/2, d). The spline conditioner output is in slab layout:
// parameter p of half-lane j at column p * d/2 + j. Elementwise stages take
// per-lane parameter vectors, slot q at P[q*d .. q*d+d), and run the stage
// bodies of stages.cuh that B1-B3 use.
//
// What bounds them on an H100: the conditioner products. At the BASELINE
// config (d=64, 4 couplings, (512, 512) hidden, n=2^17) the forward is
// 2.49 M (affine) / 5.24 M (spline, K=8) multiply-adds x 2 FLOP per sample:
// 326 / 687 GFLOP, 4.9 / 10.3 ms at the 67 TFLOP/s f32 rate outside the
// tensor cores. The bytes (x, y, ladj and the weights once, ~72 MB affine)
// take ~0.02 ms. B5 does the products twice more (dh and dW), 9.7 / 20.5 ms,
// plus a recompute of the forward that this design chooses to pay. In this
// first version every product runs in f32 FMAs on the CUDA cores (no tensor
// cores, no TF32), so f32 FMA throughput is the roof.
//
// Design. The weights (5.0 MB affine, 10.5 MB spline) do not fit in a
// block's 227 KB of shared memory but do fit in the 50 MB L2, so a block owns
// a tile of T = 4 * warps rows and keeps the tile's state, its per-element
// ladj terms and two activation buffers (T x widest layer) in shared memory,
// and streams each layer's weights from L2 through a double-buffered
// shared-memory chunk of KC rows x PASS columns with cp.async. Each warp owns
// 4 rows and each lane 8 columns (stride 32) of a PASS-wide output slab: a
// 4 x 8 register tile, activations read as shared-memory broadcasts, weights
// as conflict-free rows. Epilogues and elementwise stages run elementwise on
// the tile; the per-sample ladj is a shared-memory sum. One launch runs the
// whole stack; the ragged last tile computes on zero rows and stores nothing
// for them.
//
// B5 (a) recomputes each tile's forward, keeping in shared memory what the
// reverse sweep needs of each stage's input (a coupling's target half, an
// elementwise stage's whole input) and writing each conditioner layer's
// input h_in and pre-activation to a device-memory scratch; then sweeps the
// hand-derived
// adjoints in reverse (dh = g_pre W^T in the same register-tiled product),
// overwriting each pre-activation with its cotangent g_pre, and writes gx.
// (b) coupling_dw_kernel reduces dW = sum_n h_in^T g_pre and db = sum_n g_pre
// over fixed row splits, 64 x 64 output tiles per block; the splits (and the
// wrapper's row chunks) are summed by the caller in a fixed order. No
// atomics anywhere: results are deterministic for a given grid. The
// elementwise-parameter cotangents are per-block sums (each lane owned by
// one thread), summed by the caller.
//
// The adjoints follow the torch functions _adjoint_activation,
// _adjoint_affine and _adjoint_spline of enflows_tpu_torch/ops/coupling.py
// line by line; the CPU tests hold those against autograd.

#include <cuda_runtime.h>

#include "stages.cuh"

#define ENF_CMAX_STAGES 24
#define ENF_CMAX_LAYERS 48
#define ENF_KC 8          // weight rows per shared-memory chunk
#define ENF_PASS 256      // output columns per register-tiled pass
#define ENF_DW_TILE 64    // dW output tile (rows and columns)
#define ENF_DW_RB 32      // batch rows per dW step

#define ENF_MIN_BIN 1e-3f
#define ENF_MIN_DERIV 1e-3f
#define ENF_GELU_C 0.7978845608028654f

enum { K_AFFINE = 0, K_SPLINE = 1, K_ELEM = 2 };
enum { A_TANH = 0, A_GELU = 1, A_RELU = 2, A_SILU = 3 };

// Item fields: kind, src, inverted, act, n_layers, layer0, code, slot, n_bins.
// Layer fields: K, N, W offset, W^T offset, h_in column, g_pre column.
struct CPlan {
  int n_items;
  int n_layers;
  int item[ENF_CMAX_STAGES][9];
  float itemf[ENF_CMAX_STAGES][2];  // max_log_scale, bound
  int layer[ENF_CMAX_LAYERS][6];
};

// ------------------------------------------------------------------
// Activations and their adjoints (_adjoint_activation).

__device__ __forceinline__ float sigmoidf_(float u) {
  const float e = expf(-fabsf(u));
  return (u >= 0.f ? 1.f : e) / (1.f + e);
}

__device__ __forceinline__ float act_fwd(int a, float p) {
  if (a == A_TANH) return tanhf(p);
  if (a == A_GELU)
    return 0.5f * p * (1.f + tanhf(ENF_GELU_C * (p + 0.044715f * p * p * p)));
  if (a == A_RELU) return fmaxf(p, 0.f);
  return p * sigmoidf_(p);
}

__device__ __forceinline__ float act_bwd(int a, float pre, float g) {
  if (a == A_TANH) {
    const float th = tanhf(pre);
    return g * (1.f - th * th);
  }
  if (a == A_RELU) return pre > 0.f ? g : 0.f;
  if (a == A_SILU) {
    const float sg = sigmoidf_(pre);
    return g * sg * (1.f + pre * (1.f - sg));
  }
  const float T = tanhf(ENF_GELU_C * (pre + 0.044715f * pre * pre * pre));
  return g * (0.5f * (1.f + T) + 0.5f * pre * (1.f - T * T) * ENF_GELU_C *
                                     (1.f + 3.f * 0.044715f * pre * pre));
}

// ------------------------------------------------------------------
// The register-tiled product of a tile: out[r, n] = act(sum_k in[r, k]
// W[k, n] + b[n]) for the T = 4 * warps rows of the block.
//   in:  shared, row stride lda, K columns;
//   W:   (K, N) row-major in device memory (L2-resident), b: (N) or null;
//   out: shared, row stride ldo; act < 0 for none;
//   wc:  2 * KC * PASS floats of shared memory for the weight chunks;
//   pre_g, post_g: optional device-memory rows (stride ldg) that receive the
//   pre-activation and the activated value, for the first nvalid rows.
// Ends with a __syncthreads(), so out is visible to the whole block.

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int sz = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(sz));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void load_chunk(float* wc,
                                           const float* __restrict__ W,
                                           int K, int N, int k0, int n0) {
  for (int i = threadIdx.x; i < ENF_KC * ENF_PASS; i += blockDim.x) {
    const int kk = i / ENF_PASS, c = i % ENF_PASS;
    const int k = k0 + kk, n = n0 + c;
    const bool v = k < K && n < N;
    cp_async4(wc + i, v ? W + (size_t)k * N + n : W, v);
  }
  cp_async_commit();
}

__device__ void tile_matmul(const float* in, int lda, int K,
                            const float* __restrict__ W,
                            const float* __restrict__ b, int N, float* out,
                            int ldo, int act, float* wc, float* pre_g,
                            float* post_g, size_t ldg, int nvalid) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 4;
  const int nch = (K + ENF_KC - 1) / ENF_KC;
  for (int n0 = 0; n0 < N; n0 += ENF_PASS) {
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
    load_chunk(wc, W, K, N, 0, n0);
    for (int ch = 0; ch < nch; ++ch) {
      if (ch + 1 < nch) {
        load_chunk(wc + ((ch + 1) & 1) * ENF_KC * ENF_PASS, W, K, N,
                   (ch + 1) * ENF_KC, n0);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* w = wc + (ch & 1) * ENF_KC * ENF_PASS + lane;
      const int k0 = ch * ENF_KC;
      const int kmax = min(ENF_KC, K - k0);
      if (kmax == ENF_KC) {
#pragma unroll
        for (int kk = 0; kk < ENF_KC; ++kk) {
          float a[4], wv[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = in[(r0 + i) * lda + k0 + kk];
#pragma unroll
          for (int c = 0; c < 8; ++c) wv[c] = w[kk * ENF_PASS + c * 32];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(a[i], wv[c], acc[i][c]);
        }
      } else {
        for (int kk = 0; kk < kmax; ++kk) {
          float a[4], wv[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = in[(r0 + i) * lda + k0 + kk];
#pragma unroll
          for (int c = 0; c < 8; ++c) wv[c] = w[kk * ENF_PASS + c * 32];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(a[i], wv[c], acc[i][c]);
        }
      }
      __syncthreads();  // the next chunk load overwrites this buffer
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int n = n0 + c * 32 + lane;
      if (n >= N) continue;
      const float bias = b ? __ldg(b + n) : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + i;
        const float v = acc[i][c] + bias;
        const float o = act >= 0 ? act_fwd(act, v) : v;
        out[r * ldo + n] = o;
        if (r < nvalid) {
          if (pre_g) pre_g[r * ldg + n] = v;
          if (post_g) post_g[r * ldg + n] = o;
        }
      }
    }
  }
  __syncthreads();
}

// ------------------------------------------------------------------
// Epilogues at one element of the target half: x the target value, h the
// row of the conditioner output (shared memory), j the half-lane.

__device__ __forceinline__ float affine_fwd(float x, const float* h, int da,
                                            int j, float mls, bool inv,
                                            float* el) {
  const float sc = mls * tanhf(h[j] / mls);
  const float t = h[da + j];
  if (inv) {
    *el = -sc;
    return (x - t) * expf(-sc);
  }
  *el = sc;
  return x * expf(sc) + t;
}

// _adjoint_affine: returns cx, writes the cotangents of h[j] and h[da + j].
__device__ __forceinline__ float affine_bwd(float x, const float* h, int da,
                                            int j, float mls, bool inv,
                                            float cy, float ce, float* gh) {
  const float th = tanhf(h[j] / mls);
  const float sc = mls * th;
  float cx, g_t, g_sc;
  if (inv) {
    const float e = expf(-sc);
    const float y = (x - h[da + j]) * e;
    cx = cy * e;
    g_t = -cy * e;
    g_sc = -cy * y - ce;
  } else {
    const float e = expf(sc);
    cx = cy * e;
    g_t = cy;
    g_sc = cy * x * e + ce;
  }
  gh[j] = g_sc * (1.f - th * th);
  gh[da + j] = g_t;
  return cx;
}

__device__ __forceinline__ float softplusf_(float u) {
  return fmaxf(u, 0.f) + log1pf(expf(-fabsf(u)));
}

// The selected bin of the RQ spline at one element (_spline_bins): floored
// softmax sizes, running bin edges, out-of-range elements parked in bin 0
// after the in_range mask.
struct Bin {
  bool in_range;
  int kb;
  float wk, hk, x0, y0, d0, d1;
  float mw, mh, zw, zh, cw;
};

__device__ __forceinline__ float spline_deriv(const float* h, int da, int j,
                                              int K, int kn, float shift) {
  if (kn == 0 || kn == K) return 1.f;
  return ENF_MIN_DERIV + softplusf_(h[(2 * K + kn - 1) * da + j] + shift);
}

__device__ __forceinline__ Bin spline_bin(float x, const float* h, int da,
                                          int j, int K, float bound,
                                          bool inv, float shift) {
  Bin B;
  float mw = h[j], mh = h[K * da + j];
  for (int k = 1; k < K; ++k) {
    mw = fmaxf(mw, h[k * da + j]);
    mh = fmaxf(mh, h[(K + k) * da + j]);
  }
  float zw = 0.f, zh = 0.f;
  for (int k = 0; k < K; ++k) {
    zw += expf(h[k * da + j] - mw);
    zh += expf(h[(K + k) * da + j] - mh);
  }
  const float cw = (1.f - ENF_MIN_BIN * K) * 2.f * bound;
  const float c0 = 2.f * bound * ENF_MIN_BIN;
  B.in_range = x > -bound && x < bound;
  float cx = -bound, cy = -bound;
  bool found = false;
  B.kb = 0;
  B.wk = B.hk = B.x0 = B.y0 = 0.f;
  for (int k = 0; k < K; ++k) {
    const float sw = c0 + expf(h[k * da + j] - mw) * (cw / zw);
    const float sh = c0 + expf(h[(K + k) * da + j] - mh) * (cw / zh);
    const float nx = cx + sw, ny = cy + sh;
    const float lo = inv ? cy : cx, hi = inv ? ny : nx;
    bool m = (k + 1 < K) ? (x >= lo && x < hi) : (x >= lo);
    m = m && B.in_range;
    if (k == 0) m = m || !B.in_range;
    if (m && !found) {
      found = true;
      B.kb = k;
      B.wk = sw;
      B.hk = sh;
      B.x0 = cx;
      B.y0 = cy;
    }
    cx = nx;
    cy = ny;
  }
  B.d0 = spline_deriv(h, da, j, K, B.kb, shift);
  B.d1 = spline_deriv(h, da, j, K, B.kb + 1, shift);
  B.mw = mw;
  B.mh = mh;
  B.zw = zw;
  B.zh = zh;
  B.cw = cw;
  return B;
}

// _spline_solve: xi (clamped), the raw xi, and the output before the tails.
__device__ __forceinline__ float spline_solve(const Bin& B, float x,
                                              bool inv, float* xi_out,
                                              float* xi_raw_out) {
  const float s = B.hk / B.wk;
  const float t = B.d1 + B.d0 - 2.f * s;
  if (inv) {
    const float dy = B.in_range ? x - B.y0 : 0.5f * B.hk;
    const float a = B.hk * (s - B.d0) + dy * t;
    const float b = B.hk * B.d0 - dy * t;
    const float c = -s * dy;
    const float root = sqrtf(fmaxf(b * b - 4.f * a * c, 0.f));
    const float q = -0.5f * (b + (b >= 0.f ? 1.f : -1.f) * root);
    const float r1 = q != 0.f ? c / q : 0.f;
    const float r2 = a != 0.f ? q / a : r1;
    const bool use_r1 = r1 >= -1e-6f && r1 <= 1.f + 1e-6f;
    const float xr = use_r1 ? r1 : r2;
    const float xi = fminf(fmaxf(xr, 0.f), 1.f);
    *xi_out = xi;
    *xi_raw_out = xr;
    return B.x0 + xi * B.wk;
  }
  const float xr = B.in_range ? (x - B.x0) / B.wk : 0.5f;
  const float xi = fminf(fmaxf(xr, 0.f), 1.f);
  *xi_out = xi;
  *xi_raw_out = xr;
  return B.y0 + B.hk * (s * xi * xi + B.d0 * xi * (1.f - xi)) /
                    (s + t * xi * (1.f - xi));
}

// _spline_epilogue at one element.
__device__ __forceinline__ float spline_fwd(float x, const float* h, int da,
                                            int j, int K, float bound,
                                            bool inv, float shift,
                                            float* el) {
  const Bin B = spline_bin(x, h, da, j, K, bound, inv, shift);
  float xi, xr;
  const float y = spline_solve(B, x, inv, &xi, &xr);
  const float s = B.hk / B.wk;
  const float t = B.d1 + B.d0 - 2.f * s;
  const float omxi = 1.f - xi;
  const float denom = s + t * xi * omxi;
  const float num =
      s * s * (B.d1 * xi * xi + 2.f * s * xi * omxi + B.d0 * omxi * omxi);
  const float lf = logf(num) - 2.f * logf(denom);
  *el = B.in_range ? (inv ? -lf : lf) : 0.f;
  return B.in_range ? y : x;
}

// _adjoint_spline at one element: returns cx, writes the 3K-1 cotangents of
// the slab-layout conditioner output into gh[p * da + j].
__device__ float spline_bwd(float x, const float* h, int da, int j, int K,
                            float bound, bool inv, float shift, float cy,
                            float ce, float* gh) {
  const Bin B = spline_bin(x, h, da, j, K, bound, inv, shift);
  if (!B.in_range) {
    for (int p = 0; p < 3 * K - 1; ++p) gh[p * da + j] = 0.f;
    return cy;
  }
  float xi, xr;
  spline_solve(B, x, inv, &xi, &xr);
  const float wk = B.wk, hk = B.hk, d0 = B.d0, d1 = B.d1;
  const float s = hk / wk;
  const float t = d1 + d0 - 2.f * s;
  const float u = xi * (1.f - xi);
  const float omxi = 1.f - xi;
  const float Nn = s * xi * xi + d0 * u;
  const float D = s + t * u;
  const float M = d1 * xi * xi + 2.f * s * u + d0 * omxi * omxi;
  const float D2 = D * D;
  const float y_xi =
      hk * ((2.f * s * xi + d0 * (1.f - 2.f * xi)) * D -
            Nn * t * (1.f - 2.f * xi)) / D2;
  const float y_s = hk * (xi * xi * D - Nn * (1.f - 2.f * u)) / D2;
  const float y_d0 = hk * (u * D - Nn * u) / D2;
  const float y_d1 = -hk * Nn * u / D2;
  const float L_xi =
      (2.f * d1 * xi + 2.f * s * (1.f - 2.f * xi) - 2.f * d0 * omxi) / M -
      2.f * t * (1.f - 2.f * xi) / D;
  const float L_s = 2.f / s + 2.f * u / M - 2.f * (1.f - 2.f * u) / D;
  const float L_d0 = omxi * omxi / M - 2.f * u / D;
  const float L_d1 = xi * xi / M - 2.f * u / D;
  float cx, g_x0, g_wk, g_y0, g_hk, g_s, g_d0, g_d1;
  if (inv) {
    const float g_xi = cy * wk - ce * L_xi;
    const float lam = -g_xi / y_xi;
    cx = g_xi / y_xi;
    g_y0 = lam;
    g_hk = lam * Nn / D;
    g_s = lam * y_s - ce * L_s;
    g_d0 = lam * y_d0 - ce * L_d0;
    g_d1 = lam * y_d1 - ce * L_d1;
    g_x0 = cy;
    g_wk = cy * xi;
  } else {
    float g_xi = cy * y_xi + ce * L_xi;
    if (!(xr >= 0.f && xr <= 1.f)) g_xi = 0.f;
    cx = g_xi / wk;
    g_x0 = -g_xi / wk;
    g_wk = -g_xi * xi / wk;
    g_y0 = cy;
    g_hk = cy * Nn / D;
    g_s = cy * y_s + ce * L_s;
    g_d0 = cy * y_d0 + ce * L_d0;
    g_d1 = cy * y_d1 + ce * L_d1;
  }
  g_hk = g_hk + g_s / wk;
  g_wk = g_wk - g_s * s / wk;
  // Bin sizes: the selected bin's size, and every size before it through
  // the running edge x0 / y0; then the floored softmax, size_k = c0 + cw p_k.
  const int kb = B.kb;
  for (int half = 0; half < 2; ++half) {
    const int base = half * K;
    const float m = half ? B.mh : B.mw, z = half ? B.zh : B.zw;
    const float g_sel = half ? g_hk : g_wk, g_edge = half ? g_y0 : g_x0;
    float S = 0.f;
    for (int k = 0; k < K; ++k) {
      const float p = expf(h[(base + k) * da + j] - m) / z;
      const float g = k == kb ? g_sel : (k < kb ? g_edge : 0.f);
      S += p * g;
      gh[(base + k) * da + j] = p;
    }
    for (int k = 0; k < K; ++k) {
      const float g = k == kb ? g_sel : (k < kb ? g_edge : 0.f);
      gh[(base + k) * da + j] = B.cw * gh[(base + k) * da + j] * (g - S);
    }
  }
  // Interior slopes: deriv(kn) = MIN_DERIV + softplus(raw[kn-1] + shift).
  for (int i = 0; i < K - 1; ++i) {
    const float sig = sigmoidf_(h[(2 * K + i) * da + j] + shift);
    const float g = (kb == i + 1 ? g_d0 : 0.f) + (kb == i ? g_d1 : 0.f);
    gh[(2 * K + i) * da + j] = g * sig;
  }
  return cx;
}

// ------------------------------------------------------------------
// One coupling's conditioner forward on the tile: the src half of S (row
// stride d) through every layer, ping-ponging between H0 and H1. Returns the
// buffer holding the output. With scratch rows given (B5), writes each
// layer's input h_in and pre-activation there.
__device__ const float* conditioner_fwd(const CPlan& plan, const int* it,
                                        const float* S, int d, float* H0,
                                        float* H1, int ldw, float* wc,
                                        const float* __restrict__ W,
                                        float* scr, size_t cols, int nvalid) {
  const int src = it[1], act = it[3], nl = it[4], l0 = it[5];
  const int da = d / 2;
  if (scr) {
    const int col = plan.layer[l0][4];
    for (int e = threadIdx.x; e < nvalid * da; e += blockDim.x) {
      const int r = e / da, k = e - r * da;
      scr[r * cols + col + k] = S[r * d + src * da + k];
    }
  }
  const float* in = S + src * da;
  int lda = d;
  for (int l = 0; l < nl; ++l) {
    const int* L = plan.layer[l0 + l];
    const int K = L[0], N = L[1], woff = L[2];
    float* out = (l & 1) ? H1 : H0;
    const bool last = l + 1 == nl;
    float* pre_g = scr ? scr + L[5] : nullptr;
    float* post_g = (scr && !last) ? scr + plan.layer[l0 + l + 1][4] : nullptr;
    tile_matmul(in, lda, K, W + woff, W + woff + (size_t)K * N, N, out, ldw,
                last ? -1 : act, wc, pre_g, post_g, cols, nvalid);
    in = out;
    lda = ldw;
  }
  return in;
}

// The epilogue of a coupling on the tile: reads the target half of `in`
// (row stride d) and the conditioner output h (row stride ldw), writes the
// new target half to `out` and, if L is not null, adds the ladj terms there.
__device__ void epilogue_fwd(const int* it, const float* itf, const float* in,
                             float* out, float* L, const float* h, int ldw,
                             int T, int d, float shift) {
  const int da = d / 2, tgt = 1 - it[1], K = it[8];
  const bool inv = it[2] != 0, spline = it[0] == K_SPLINE;
  for (int e = threadIdx.x; e < T * da; e += blockDim.x) {
    const int r = e / da, j = e - r * da;
    const int idx = r * d + tgt * da + j;
    float el;
    const float y =
        spline ? spline_fwd(in[idx], h + r * ldw, da, j, K, itf[1], inv,
                            shift, &el)
               : affine_fwd(in[idx], h + r * ldw, da, j, itf[0], inv, &el);
    out[idx] = y;
    if (L) L[idx] += el;
  }
  __syncthreads();
}

// ------------------------------------------------------------------
// B4: replaces _fused_coupling_impl (ops/pallas/coupling.py:677-716).
// Shared memory, in floats: S (T x d) the state, Lel (T x d) the per-element
// ladj terms, H0 and H1 (T x ldw), the weight chunks (2 x KC x PASS).
// Grid-stride loop over tiles of T = blockDim / 8 rows.
__global__ void __launch_bounds__(256)
    coupling_fwd_kernel(const float* __restrict__ x, float* __restrict__ y,
                        float* __restrict__ ladj,
                        const float* __restrict__ W,
                        const float* __restrict__ P,
                        const __grid_constant__ CPlan plan, long long n,
                        int d, int ldw, float shift) {
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x / 8;
  float* S = smem;
  float* Lel = S + T * d;
  float* H0 = Lel + T * d;
  float* H1 = H0 + T * ldw;
  float* wc = H1 + T * ldw;
  const long long ntiles = (n + T - 1) / T;
  for (long long ti = blockIdx.x; ti < ntiles; ti += gridDim.x) {
    const long long r0 = ti * T;
    const int ns = (int)min((long long)T, n - r0);
    for (int e = threadIdx.x; e < T * d; e += blockDim.x) {
      S[e] = e < ns * d ? x[r0 * d + e] : 0.f;
      Lel[e] = 0.f;
    }
    __syncthreads();
    for (int i = 0; i < plan.n_items; ++i) {
      const int* it = plan.item[i];
      if (it[0] == K_ELEM) {
        const int code = it[6], slot = it[7];
        for (int e = threadIdx.x; e < T * d; e += blockDim.x) {
          float el;
          S[e] = stage_fwd(code, S[e], P, slot, d, e % d, &el);
          Lel[e] += el;
        }
        __syncthreads();
      } else {
        const float* h = conditioner_fwd(plan, it, S, d, H0, H1, ldw, wc, W,
                                         nullptr, 0, 0);
        epilogue_fwd(it, plan.itemf[i], S, S, Lel, h, ldw, T, d, shift);
      }
    }
    for (int e = threadIdx.x; e < ns * d; e += blockDim.x) y[r0 * d + e] = S[e];
    for (int r = threadIdx.x; r < ns; r += blockDim.x) {
      float sum = 0.f;
      for (int k = 0; k < d; ++k) sum += Lel[r * d + k];
      ladj[r0 + r] = sum;
    }
    __syncthreads();
  }
}

// B5 (a): replaces the recompute + in-tile vjp of _fused_coupling_bwd_impl
// (ops/pallas/coupling.py:616-674). For the `rows` rows of one chunk:
// gx from gy (physical lane order) and gl; every conditioner layer's input
// h_in and pre-activation cotangent g_pre into `scr` (rows x cols, the
// columns of layer l at layer[l][4] and layer[l][5]); per-block sums of the
// elementwise-parameter cotangents into p_part (grid, n_pslots * d).
// Shared memory, in floats: SV what the reverse sweep needs of each stage's
// input (an elementwise stage's whole input, T x d; a coupling's target
// half, T x d/2: its conditioner's values are in the scratch), SC (T x d)
// the state during the recompute and then the running cotangent, G (T) the
// ladj cotangents, H0 and H1 (T x ldw), the weight chunks (2 x KC x PASS),
// PACC (n_pslots x d).
__global__ void __launch_bounds__(256)
    coupling_bwd_kernel(const float* __restrict__ x,
                        const float* __restrict__ gy,
                        const float* __restrict__ gl,
                        float* __restrict__ gx, const float* __restrict__ W,
                        const float* __restrict__ Wt,
                        const float* __restrict__ P,
                        const __grid_constant__ CPlan plan, long long rows,
                        int d, int ldw, int n_pslots, float* scratch,
                        long long cols, float* __restrict__ p_part,
                        float shift) {
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x / 8;
  const int da = d / 2;
  const int TD = T * d;
  const int ni = plan.n_items;
  int sv_len = 0;
  for (int i = 0; i < ni; ++i) sv_len += plan.item[i][0] == K_ELEM ? TD : T * da;
  float* SV = smem;
  float* SC = SV + sv_len;
  float* G = SC + TD;
  float* H0 = G + T;
  float* H1 = H0 + T * ldw;
  float* wc = H1 + T * ldw;
  float* PACC = wc + 2 * ENF_KC * ENF_PASS;
  for (int q = threadIdx.x; q < n_pslots * d; q += blockDim.x) PACC[q] = 0.f;

  const long long ntiles = (rows + T - 1) / T;
  for (long long ti = blockIdx.x; ti < ntiles; ti += gridDim.x) {
    const long long r0 = ti * T;
    const int ns = (int)min((long long)T, rows - r0);
    float* scr = scratch + r0 * cols;
    for (int e = threadIdx.x; e < TD; e += blockDim.x)
      SC[e] = e < ns * d ? x[r0 * d + e] : 0.f;
    for (int r = threadIdx.x; r < T; r += blockDim.x)
      G[r] = r < ns ? gl[r0 + r] : 0.f;
    __syncthreads();

    // Forward: what the reverse sweep needs of each stage's input saved to
    // SV; the conditioners' rows to the scratch.
    for (int i = 0, off = 0; i < ni; ++i) {
      const int* it = plan.item[i];
      float* sv = SV + off;
      if (it[0] == K_ELEM) {
        const int code = it[6], slot = it[7];
        for (int e = threadIdx.x; e < TD; e += blockDim.x) {
          float el;
          sv[e] = SC[e];
          SC[e] = stage_fwd(code, SC[e], P, slot, d, e % d, &el);
        }
        __syncthreads();
        off += TD;
      } else {
        const int tgt = 1 - it[1];
        for (int e = threadIdx.x; e < T * da; e += blockDim.x) {
          const int r = e / da, j = e - r * da;
          sv[e] = SC[r * d + tgt * da + j];
        }
        const float* h = conditioner_fwd(plan, it, SC, d, H0, H1, ldw, wc,
                                         W, scr, (size_t)cols, ns);
        if (i + 1 < ni)
          epilogue_fwd(it, plan.itemf[i], SC, SC, nullptr, h, ldw, T, d,
                       shift);
        off += T * da;
      }
    }

    float* CY = SC;
    for (int e = threadIdx.x; e < TD; e += blockDim.x)
      CY[e] = e < ns * d ? gy[r0 * d + e] : 0.f;
    __syncthreads();

    // Reverse sweep of the hand-derived adjoints.
    for (int i = ni - 1, off = sv_len; i >= 0; --i) {
      const int* it = plan.item[i];
      off -= it[0] == K_ELEM ? TD : T * da;
      const float* cur = SV + off;
      if (it[0] == K_ELEM) {
        // One thread per lane, rows in order: each PACC entry has one owner.
        const int code = it[6], slot = it[7], np = n_params(code);
        for (int k = threadIdx.x; k < d; k += blockDim.x) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          for (int r = 0; r < ns; ++r) {
            float g[4];
            CY[r * d + k] = stage_bwd(code, cur[r * d + k], P, slot, d, k,
                                      CY[r * d + k], G[r], g);
            for (int q = 0; q < np; ++q) acc[q] += g[q];
          }
          for (int q = 0; q < np; ++q) PACC[(slot + q) * d + k] += acc[q];
        }
        __syncthreads();
        continue;
      }
      const int src = it[1], tgt = 1 - src, act = it[3], nl = it[4],
                l0 = it[5], K = it[8];
      const bool inv = it[2] != 0, spline = it[0] == K_SPLINE;
      // The conditioner output (last layer's pre-activation) from the
      // scratch into H0.
      {
        const int* L = plan.layer[l0 + nl - 1];
        const int N = L[1], col = L[5];
        for (int e = threadIdx.x; e < T * N; e += blockDim.x) {
          const int r = e / N, c = e - r * N;
          H0[r * ldw + c] = r < ns ? scr[r * cols + col + c] : 0.f;
        }
      }
      __syncthreads();
      for (int e = threadIdx.x; e < T * da; e += blockDim.x) {
        const int r = e / da, j = e - r * da;
        const int idx = r * d + tgt * da + j;
        const float* h = H0 + r * ldw;
        float* gh = H1 + r * ldw;
        CY[idx] = spline ? spline_bwd(cur[e], h, da, j, K,
                                      plan.itemf[i][1], inv, shift, CY[idx],
                                      G[r], gh)
                         : affine_bwd(cur[e], h, da, j, plan.itemf[i][0],
                                      inv, CY[idx], G[r], gh);
      }
      __syncthreads();
      // Back through the layers: g (T x N_l) holds g_pre of layer l.
      float* g = H1;
      float* o = H0;
      for (int l = nl - 1; l >= 0; --l) {
        const int* L = plan.layer[l0 + l];
        const int Kl = L[0], Nl = L[1];
        for (int e = threadIdx.x; e < ns * Nl; e += blockDim.x) {
          const int r = e / Nl, c = e - r * Nl;
          scr[r * cols + L[5] + c] = g[r * ldw + c];
        }
        tile_matmul(g, ldw, Nl, Wt + L[3], nullptr, Kl, o, ldw, -1, wc,
                    nullptr, nullptr, 0, 0);
        if (l > 0) {
          const int pcol = plan.layer[l0 + l - 1][5];
          for (int e = threadIdx.x; e < T * Kl; e += blockDim.x) {
            const int r = e / Kl, c = e - r * Kl;
            const float pre = r < ns ? scr[r * cols + pcol + c] : 0.f;
            o[r * ldw + c] = act_bwd(act, pre, o[r * ldw + c]);
          }
        } else {
          for (int e = threadIdx.x; e < T * da; e += blockDim.x) {
            const int r = e / da, c = e - r * da;
            CY[r * d + src * da + c] += o[r * ldw + c];
          }
        }
        __syncthreads();
        float* sw = g;
        g = o;
        o = sw;
      }
    }

    for (int e = threadIdx.x; e < ns * d; e += blockDim.x) gx[r0 * d + e] = CY[e];
    __syncthreads();
  }
  for (int q = threadIdx.x; q < n_pslots * d; q += blockDim.x)
    p_part[(size_t)blockIdx.x * n_pslots * d + q] = PACC[q];
}

// B5 (b): dW = sum_r h_in[r]^T g_pre[r] and db = sum_r g_pre[r] for every
// layer, over the `rows` scratch rows of one chunk, split into nsplit fixed
// row ranges (blockIdx.y). A block owns a 64 x 64 tile of a layer's
// (K + 1) x N block (row K is the bias, whose input is 1), and writes it to
// w_part[split * w_len + W offset + k * N + n]: the same flat layout as the
// weights, since each bias follows its W. Each thread holds a 4 x 4 tile.
__global__ void __launch_bounds__(256)
    coupling_dw_kernel(const float* __restrict__ scratch, long long cols,
                       const __grid_constant__ CPlan plan, long long rows,
                       int nsplit, float* __restrict__ w_part,
                       long long w_len) {
  __shared__ float A[ENF_DW_RB][ENF_DW_TILE];
  __shared__ float B[ENF_DW_RB][ENF_DW_TILE];
  int t = blockIdx.x, l = 0, tn_count = 1;
  for (; l < plan.n_layers; ++l) {
    const int K = plan.layer[l][0], N = plan.layer[l][1];
    tn_count = (N + ENF_DW_TILE - 1) / ENF_DW_TILE;
    const int tiles = (K + 1 + ENF_DW_TILE - 1) / ENF_DW_TILE * tn_count;
    if (t < tiles) break;
    t -= tiles;
  }
  if (l >= plan.n_layers) return;
  const int* L = plan.layer[l];
  const int K = L[0], N = L[1], woff = L[2], chin = L[4], cg = L[5];
  const int k0 = (t / tn_count) * ENF_DW_TILE;
  const int n0 = (t % tn_count) * ENF_DW_TILE;
  const int s = blockIdx.y;
  const long long rb = rows * s / nsplit, re = rows * (s + 1) / nsplit;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;
  for (long long r = rb; r < re; r += ENF_DW_RB) {
    for (int i = threadIdx.x; i < ENF_DW_RB * ENF_DW_TILE; i += blockDim.x) {
      const int rr = i / ENF_DW_TILE, c = i % ENF_DW_TILE;
      const long long row = r + rr;
      const bool ok = row < re;
      const int k = k0 + c, nn = n0 + c;
      const float* srow = scratch + row * cols;
      A[rr][c] = ok ? (k < K ? srow[chin + k] : (k == K ? 1.f : 0.f)) : 0.f;
      B[rr][c] = ok && nn < N ? srow[cg + nn] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < ENF_DW_RB; ++rr) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = A[rr][ty + 16 * i];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) b[jj] = B[rr][tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(a[i], b[jj], acc[i][jj]);
    }
    __syncthreads();
  }
  float* out = w_part + (size_t)s * w_len + woff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty + 16 * i;
    if (k > K) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int nn = n0 + tx + 16 * jj;
      if (nn < N) out[(size_t)k * N + nn] = acc[i][jj];
    }
  }
}

// ------------------------------------------------------------------
// C interface. Each function launches on `stream`, does not synchronize, and
// returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a plan or shape the kernels do not take.

static int make_cplan(CPlan* p, const int* si, const float* sf, int n_items,
                      const int* li, int n_layers) {
  if (n_items < 1 || n_items > ENF_CMAX_STAGES || n_layers < 0 ||
      n_layers > ENF_CMAX_LAYERS)
    return 1;
  *p = CPlan{};
  p->n_items = n_items;
  p->n_layers = n_layers;
  for (int i = 0; i < n_items; ++i) {
    for (int f = 0; f < 9; ++f) p->item[i][f] = si[i * 9 + f];
    p->itemf[i][0] = sf[i * 2];
    p->itemf[i][1] = sf[i * 2 + 1];
    const int* it = p->item[i];
    if (it[0] != K_ELEM && (it[4] < 1 || it[5] < 0 || it[5] + it[4] > n_layers))
      return 1;
  }
  for (int l = 0; l < n_layers; ++l)
    for (int f = 0; f < 6; ++f) p->layer[l][f] = li[l * 6 + f];
  return 0;
}

static bool block_ok(int warps) {
  return warps == 2 || warps == 4 || warps == 8;
}

extern "C" int enf_coupling_fwd(const float* x, float* y, float* ladj,
                                const float* W, const float* P,
                                const int* si, const float* sf, int n_items,
                                const int* li, int n_layers, long long n,
                                int d, int ldw, int warps, int smem, int grid,
                                float shift, void* stream) {
  CPlan plan;
  if (make_cplan(&plan, si, sf, n_items, li, n_layers) || !block_ok(warps) ||
      d < 2 || d % 2)
    return (int)cudaErrorInvalidValue;
  const int T = 4 * warps;
  const long long need =
      4LL * ((long long)T * (2 * d + 2 * ldw) + 2 * ENF_KC * ENF_PASS);
  if (need > smem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      coupling_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  coupling_fwd_kernel<<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      x, y, ladj, W, P, plan, n, d, ldw, shift);
  return (int)cudaGetLastError();
}

extern "C" int enf_coupling_bwd(const float* x, const float* gy,
                                const float* gl, float* gx, const float* W,
                                const float* Wt, const float* P,
                                const int* si, const float* sf, int n_items,
                                const int* li, int n_layers, long long rows,
                                int d, int ldw, int warps, int smem, int grid,
                                int n_pslots, float* scratch, long long cols,
                                float* p_part, float shift, void* stream) {
  CPlan plan;
  if (make_cplan(&plan, si, sf, n_items, li, n_layers) || !block_ok(warps) ||
      d < 2 || d % 2)
    return (int)cudaErrorInvalidValue;
  const int T = 4 * warps;
  long long sv_row = 0;  // floats of SV per row
  for (int i = 0; i < n_items; ++i)
    sv_row += plan.item[i][0] == K_ELEM ? d : d / 2;
  const long long need =
      4LL * ((long long)T * (sv_row + d + 1 + 2 * ldw) +
             2 * ENF_KC * ENF_PASS + (long long)n_pslots * d);
  if (need > smem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      coupling_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  coupling_bwd_kernel<<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      x, gy, gl, gx, W, Wt, P, plan, rows, d, ldw, n_pslots, scratch, cols,
      p_part, shift);
  return (int)cudaGetLastError();
}

extern "C" int enf_coupling_dw(const float* scratch, long long cols,
                               const int* li, int n_layers, long long rows,
                               int nsplit, float* w_part, long long w_len,
                               void* stream) {
  CPlan plan = CPlan{};
  if (n_layers < 1 || n_layers > ENF_CMAX_LAYERS || nsplit < 1)
    return (int)cudaErrorInvalidValue;
  plan.n_layers = n_layers;
  int tiles = 0;
  for (int l = 0; l < n_layers; ++l) {
    for (int f = 0; f < 6; ++f) plan.layer[l][f] = li[l * 6 + f];
    const int K = plan.layer[l][0], N = plan.layer[l][1];
    tiles += (K + ENF_DW_TILE) / ENF_DW_TILE *
             ((N + ENF_DW_TILE - 1) / ENF_DW_TILE);
  }
  dim3 grid(tiles, nsplit);
  coupling_dw_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      scratch, cols, plan, rows, nsplit, w_part, w_len);
  return (int)cudaGetLastError();
}
