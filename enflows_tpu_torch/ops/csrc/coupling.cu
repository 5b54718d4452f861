// Fused coupling-stack kernels for Hopper (sm_90a): B4 forward+ladj of a
// whole coupling stack, B5 its backward (a per-tile recompute and reverse
// sweep, and a batch reduction of the conditioner weight gradients).
//
// Replace the Pallas TPU kernels of enflows_tpu/ops/pallas/coupling.py:
//   B4 coupling_fwd_kernel  <- _fused_coupling_impl (:677-716; kernel
//      _build_coupling_kernel :517, body _tile_apply :451, spline epilogue
//      _spline_slab_epilogue :322)
//   B5 coupling_bwd_kernel + coupling_dw_kernel <- _fused_coupling_bwd_impl
//      (:616-674; kernel _build_coupling_bwd_kernel :595)
//
// The stack arrives as the padded plan of enflows_tpu_torch/ops/coupling.py
// (``_padded``, ``_plan_arrays``): per stage its kind (affine, spline or
// elementwise), the physical half that conditions, the flags, the
// activation, its conditioner layers and its last-layer slabs; per layer
// (Kp, Np), K and N padded to multiples of 8 with zeros, and the offsets of
// its W and W^T (packed in the B-fragment order of mma.sync, rounded to
// TF32) and its bias in one kernel buffer, Permutes already absorbed. The
// state of a sample stays in physical lane order as two halves [0, d/2) and
// [d/2, d). The last layer is lane-grouped: slab s (width SW, a multiple of
// 8) holds parameter p of its half-lane jj at column s * SW + p * G + jj.
// Elementwise stages take per-lane parameter vectors, slot q at
// P[q*d .. q*d+d), and run the stage bodies of stages.cuh that B1-B3 use.
//
// Precision. Every conditioner product runs on the tensor cores in TF32
// with f32 accumulation: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32.
// That is the counterpart of the reference's DEFAULT-precision matmuls, one
// bf16 pass of the MXU (TF32 keeps 10 mantissa bits to bf16's 7). Weights
// are rounded to TF32 once by the wrapper and activations once where they
// are written, so B4's inner loop converts nothing; B5 keeps each
// pre-activation cotangent in f32 in its scratch, so that db is an f32 sum
// as in the plain version, and rounds it where a product reads it. Biases,
// activations, epilogues, adjoints and ladj stay in f32. wgmma would reach
// further toward the 495 TFLOP/s roof, but its TF32 form wants both
// operands K-major in shared memory in its own swizzled layouts and a
// warpgroup-wide asynchronous protocol; mma.sync takes A from any
// shared-memory layout the block already keeps and B as packed fragments,
// which is what a first tensor-core design of a kernel this long (every
// stage kind, slabs, interleaved elementwise stages) can hold right. wgmma
// is the next step.
//
// What bounds them on an H100 (BASELINE: d=64, 4 couplings, (512, 512)
// gelu conditioners, n=2^17):
//   * the TF32 product rate: B4 does 326 / 687 GFLOP (affine / spline, K=8),
//     0.66 / 1.39 ms at 495 TFLOP/s; B5 twice that for dh and dW plus the
//     recompute. Design: mma.sync on tiles of 64 rows x 512 columns per
//     pass, 16 warps each owning 32 x 64 (a 2 x 8 grid of m16n8 tiles, 64
//     accumulators in registers), so each A fragment read from shared
//     memory feeds 8 products and each B fragment 2; 16 warps rather than
//     8 of 32 x 128 hide more of the shared-memory and L2 latency and stay
//     under 128 registers.
//   * the L2 weight reads: the weights (5.0 / 10.5 MB) fit the 50 MB L2 but
//     not a block's shared memory, so every row tile streams them once.
//     Design: 64-row tiles (2^17/64 x 5.0 MB = 10.2 GB affine, 21.5 GB
//     spline; a 32-row tile would read twice that), weights packed so one
//     k-step of a pass is one contiguous run, copied by 16-byte cp.async
//     into a ring of 3 stages with one barrier per 8-deep k-step.
//   * the scratch bytes of B5: each layer's input and pre-activation
//     cotangent per row (34.3 / 45.1 KB per row) go to device memory for
//     the dW reduction. Design: the scratch is layer-major, each layer's
//     h_in (rows x Kp) and g_pre (rows x Np) contiguous; the dW kernel's
//     blocks are ordered so that the output tiles of one layer and one row
//     split are launched together and walk the same rows in step, so that
//     a row read from device memory by one tile can still be in L2 when
//     its neighbours read it. The row splits are not sized to L2 (at
//     BASELINE a split of one 512-wide layer is ~90 MB), and how often
//     device memory is really read is not measured: every tile reading
//     its own columns is 2.6x the scratch at BASELINE, once is 1x.
//
// B4. A block owns a tile of TM rows (64; 16 where a layer is wider than
// 512 or shared memory does not fit) and keeps in shared memory the state
// S (TM x d), the per-element ladj terms (TM x d), one activation buffer H
// (TM x ldh) and the weight ring. A coupling copies its src half into H
// (zero-padded to Kp, rounded to TF32); each hidden layer accumulates its
// whole output in registers, then bias and activation are written back
// into H in place after a barrier; the last layer runs slab by slab into
// the ring (free between passes) and the slab's epilogue updates the target
// half of S at once. Persistent grid-stride loop over tiles; the ragged
// last tile computes on zero rows and stores nothing for them.
//
// B5 (a) recomputes each tile's forward the same way, keeping in shared
// memory what the reverse sweep needs of each stage's input (a coupling's
// target half, an elementwise stage's whole input) and writing every
// layer's input h_in and pre-activation to the scratch. In training B4
// writes those rows itself (given a scratch and a stage-input buffer for
// the whole batch), and the sweep reads the stage inputs back instead of
// recomputing: a fraction of a millisecond more in B4 for a third of B5
// at BASELINE, for 34 / 45 KB per row held until the backward. The reverse
// sweep
// reads each slab of the conditioner output back, runs the hand-derived
// adjoint in place, writes g_pre, then accumulates dh = g_pre W^T over the
// slabs in registers (the same tile product on the packed W^T), applies the
// activation's adjoint against the stored pre-activation and walks down the
// layers. (b) coupling_dw_kernel forms dW = h_in^T g_pre on the tensor
// cores in 128 x 128 output tiles (8 warps of 64 x 32) over fixed row
// splits, and db = sum g_pre as column sums in the blocks of the first row
// of tiles. The splits and the wrapper's chunks are summed by the caller in
// a fixed order. No atomics anywhere: results are deterministic for a given
// grid. The elementwise-parameter cotangents are per-block sums (each lane
// owned by one thread), summed by the caller.
//
// The adjoints follow the torch functions _adjoint_activation,
// _adjoint_affine and _adjoint_spline of enflows_tpu_torch/ops/coupling.py
// line by line; the CPU tests hold those against autograd.

#include <cuda_runtime.h>

#include "stages.cuh"

#define ENF_CMAX_STAGES 24
#define ENF_CMAX_LAYERS 48
#define ENF_RING 3        // weight ring stages, one 8-row k-step each
#define ENF_WARPS 16      // warps per block of B4 / B5's sweep
#define ENF_NF 8          // n8 tiles per warp per pass
#define ENF_DW_TILE 128   // dW output tile (rows and columns)
#define ENF_DW_RB 32      // batch rows per dW ring stage
#define ENF_DW_LD 136     // row stride of a dW stage tile (8 mod 32)

#define ENF_MIN_BIN 1e-3f
#define ENF_MIN_DERIV 1e-3f
#define ENF_GELU_C 0.7978845608028654f

enum { K_AFFINE = 0, K_SPLINE = 1, K_ELEM = 2 };
enum { A_TANH = 0, A_GELU = 1, A_RELU = 2, A_SILU = 3 };

// Item fields: kind, src, inverted, act, n_layers, layer0, code, slot,
// n_bins, G (half-lanes per slab), SW (slab width), slabs.
// Layer fields: Kp, Np, packed W offset, packed W^T offset, bias offset,
// scratch column base (h_in, then g_pre at + Kp), natural dW offset.
struct CPlan {
  int n_items;
  int n_layers;
  int item[ENF_CMAX_STAGES][12];
  float itemf[ENF_CMAX_STAGES][2];  // max_log_scale, bound
  int layer[ENF_CMAX_LAYERS][7];
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
// The TF32 tile product.

// Round to TF32, to nearest with ties away from zero (the wrapper rounds
// the weights the same way).
__device__ __forceinline__ float tf32r(float v) {
  unsigned u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(v));
  return __uint_as_float(u);
}

__device__ __forceinline__ void mma_tf32(float* c, const unsigned* a,
                                         float b0, float b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(__float_as_uint(b0)),
        "r"(__float_as_uint(b1)));
}

// 16-byte copy to shared memory; src_bytes 0 fills zeros.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes = 16) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The block's geometry: ENF_WARPS warps in WM x WN, each owning MF m16
// tiles of rows and up to ENF_NF n8 tiles of a pass (n-tile j * WN + wn,
// so that a narrow pass still spreads over every warp).
template <int MF, int WM>
struct Geo {
  static constexpr int TM = 16 * MF * WM;     // rows per block
  static constexpr int WN = ENF_WARPS / WM;
  static constexpr int PASS = WN * ENF_NF * 8;  // columns per pass
  static constexpr int RING = ENF_RING * 8 * PASS;  // floats
};

template <int MF>
struct Acc {
  float v[MF][ENF_NF][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < MF; ++m)
#pragma unroll
      for (int j = 0; j < ENF_NF; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) v[m][j][q] = 0.f;
  }
};

// acc += A (TM x 8*ksteps, shared memory, row stride lda = 4 mod 8) times
// the k-steps [kk0, kk0 + ksteps) and n-tiles [nt0, nt0 + ntiles) of a
// fragment-packed matrix Bp with ntot n-tiles per k-step (ntiles <= PASS/8).
// The B fragments stream through the ring: each k-step of the pass is one
// contiguous run of ntiles * 256 bytes, copied by 16-byte cp.async, ENF_RING
// stages deep, one barrier per stage. A stage holds PASS/8 tiles: one
// k-step of a full pass, up to 8 of a narrow one (the affine last layer's
// 8 tiles, the first layer's dh), so a narrow pass does not pay a barrier
// for every 8-deep step. Starts and ends with the ring free (ends with a
// barrier, so the caller may overwrite A or the ring).
// acc += A (TM x 8*ksteps, shared memory, row stride lda = 4 mod 8) times
// the k-steps [kk0, kk0 + ksteps) and n-tiles [nt0, nt0 + ntiles) of a
// fragment-packed matrix Bp with ntot n-tiles per k-step (ntiles <= PASS/8).
// The B fragments stream through the ring: each k-step of the pass is one
// contiguous run of ntiles * 256 bytes, copied by 16-byte cp.async, ENF_RING
// stages deep, one barrier per k-step. Starts and ends with the ring free
// (ends with a barrier, so the caller may overwrite A or the ring).
template <int MF, int WM>
__device__ void tile_product(Acc<MF>& acc, const float* A, int lda,
                             int ksteps, const float* __restrict__ Bp,
                             int ntot, int kk0, int nt0, int ntiles,
                             float* ring) {
  using G = Geo<MF, WM>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / G::WN, wn = warp % G::WN;
  const int g = lane >> 2, t = lane & 3;
  const int pieces = ntiles * 16;
  auto load = [&](int kk) {
    const float* src = Bp + ((size_t)(kk0 + kk) * ntot + nt0) * 64;
    float* dst = ring + (kk % ENF_RING) * 8 * G::PASS;
    for (int i = threadIdx.x; i < pieces; i += blockDim.x)
      cp_async16(dst + 4 * i, src + 4 * i);
  };
#pragma unroll
  for (int s = 0; s < ENF_RING - 1; ++s) {
    if (s < ksteps) load(s);
    cp_async_commit();
  }
  const float* arow = A + (wm * MF * 16 + g) * lda + t;
  for (int kk = 0; kk < ksteps; ++kk) {
    cp_async_wait<ENF_RING - 2>();
    __syncthreads();  // stage kk landed; stage kk - 1 is read by everyone
    if (kk + ENF_RING - 1 < ksteps) load(kk + ENF_RING - 1);
    cp_async_commit();
    const float* bs = ring + (kk % ENF_RING) * 8 * G::PASS + lane * 2;
    unsigned a[MF][4];
#pragma unroll
    for (int m = 0; m < MF; ++m) {
      const float* p = arow + m * 16 * lda + kk * 8;
      a[m][0] = __float_as_uint(p[0]);
      a[m][1] = __float_as_uint(p[8 * lda]);
      a[m][2] = __float_as_uint(p[4]);
      a[m][3] = __float_as_uint(p[8 * lda + 4]);
    }
#pragma unroll
    for (int j = 0; j < ENF_NF; ++j) {
      const int tile = j * G::WN + wn;
      if (tile < ntiles) {
        const float2 b = *reinterpret_cast<const float2*>(bs + tile * 64);
#pragma unroll
        for (int m = 0; m < MF; ++m) mma_tf32(acc.v[m][j], a[m], b.x, b.y);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// f(r, c, v) for every accumulator of the first ntiles n-tiles: row r of
// the tile, column c of the pass.
template <int MF, int WM, class F>
__device__ __forceinline__ void for_acc(Acc<MF>& acc, int ntiles, F f) {
  using G = Geo<MF, WM>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / G::WN, wn = warp % G::WN;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < MF; ++m)
#pragma unroll
    for (int j = 0; j < ENF_NF; ++j) {
      const int tile = j * G::WN + wn;
      if (tile >= ntiles) continue;
      const int r = (wm * MF + m) * 16 + g, c = tile * 8 + 2 * t;
      f(r, c, acc.v[m][j][0]);
      f(r, c + 1, acc.v[m][j][1]);
      f(r + 8, c, acc.v[m][j][2]);
      f(r + 8, c + 1, acc.v[m][j][3]);
    }
}

// The first nvalid rows of src (shared memory, row stride lds) -> dst
// (device memory, row stride ldd) in 16-byte stores (w, both strides
// multiples of 4, both bases 16-byte aligned). No barrier.
__device__ __forceinline__ void store_rows(float* dst, size_t ldd,
                                           const float* src, int lds, int w,
                                           int nvalid) {
  const int q = w / 4;
  for (int i = threadIdx.x; i < nvalid * q; i += blockDim.x) {
    const int r = i / q, c = (i - r * q) * 4;
    *reinterpret_cast<float4*>(dst + r * ldd + c) =
        *reinterpret_cast<const float4*>(src + r * lds + c);
  }
}

// dst (TM x w, row stride ldd) <- the first nvalid rows of src (row stride
// lds), zeros below, by 16-byte cp.async (w, ldd, lds multiples of 4 and
// both bases 16-byte aligned). Ends with a barrier.
template <int TM>
__device__ void load_rows(float* dst, int ldd, const float* src, size_t lds,
                          int w, int nvalid) {
  const int q = w / 4;
  for (int i = threadIdx.x; i < TM * q; i += blockDim.x) {
    const int r = i / q, c = (i - r * q) * 4;
    const bool ok = r < nvalid;
    cp_async16(dst + r * ldd + c, ok ? src + r * lds + c : src, ok ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
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
// One coupling on the tile, shared by B4 and B5's recompute.

// The scratch rows of one tile (B5); base null in B4. Layer arrays are
// layer-major: the array at column base cb, `width` wide, starts at
// base + rows * cb.
struct ScrRows {
  float* base;
  long long rows, r0;
  int nvalid;
  __device__ __forceinline__ float* at(int cb, int width) const {
    return base + rows * cb + r0 * width;
  }
};

// The conditioner from the src half of S, then the last layer slab by slab
// into O (the ring, free between passes) with each slab's epilogue on the
// target half of S (and the ladj terms into Lel, when given). With scratch
// rows, every layer's input and pre-activation go to the scratch for the
// valid rows; `epi` false skips the epilogue (B5's last stage).
template <int MF, int WM>
__device__ void coupling_fwd_tile(const CPlan& plan, const int* it,
                                  const float* itf, float* S, float* Lel,
                                  int d, float* H, int ldh, float* ring,
                                  const float* __restrict__ Wk,
                                  const ScrRows& scr, bool epi, float shift) {
  constexpr int TM = Geo<MF, WM>::TM;
  const int da = d / 2, src = it[1], act = it[3], nl = it[4], l0 = it[5];
  const bool save = scr.base != nullptr;
  {
    const int Kp = plan.layer[l0][0];
    float* hin = save ? scr.at(plan.layer[l0][5], Kp) : nullptr;
    for (int e = threadIdx.x; e < TM * Kp; e += blockDim.x) {
      const int r = e / Kp, k = e - r * Kp;
      const float v = k < da ? tf32r(S[r * d + src * da + k]) : 0.f;
      H[r * ldh + k] = v;
      if (save && r < scr.nvalid) hin[(size_t)r * Kp + k] = v;
    }
  }
  __syncthreads();
  Acc<MF> acc;
  for (int l = 0; l + 1 < nl; ++l) {  // hidden layers, in place in H
    const int* L = plan.layer[l0 + l];
    const int Kp = L[0], Np = L[1];
    const float* b = Wk + L[4];
    acc.zero();
    tile_product<MF, WM>(acc, H, ldh, Kp / 8, Wk + L[2], Np / 8, 0, 0,
                         Np / 8, ring);
    // Bias in the accumulator epilogue; the activation in a second pass
    // over H, with the accumulators dead (computed while they are live, the
    // activation's registers spill). B5's rows: the pre-activation and the
    // activated value to the scratch, in 16-byte stores.
    for_acc<MF, WM>(acc, Np / 8,
                    [&](int r, int c, float v) { H[r * ldh + c] = v + b[c]; });
    __syncthreads();
    float* pre = save ? scr.at(L[5] + Kp, Np) : nullptr;
    float* post = save ? scr.at(plan.layer[l0 + l + 1][5], Np) : nullptr;
    const int q = Np / 4;
    for (int i = threadIdx.x; i < TM * q; i += blockDim.x) {
      const int r = i / q, c = (i - r * q) * 4;
      float4* h = reinterpret_cast<float4*>(H + r * ldh + c);
      float4 v = *h;
      const bool out = save && r < scr.nvalid;
      if (out) *reinterpret_cast<float4*>(pre + (size_t)r * Np + c) = v;
      v.x = tf32r(act_fwd(act, v.x));
      v.y = tf32r(act_fwd(act, v.y));
      v.z = tf32r(act_fwd(act, v.z));
      v.w = tf32r(act_fwd(act, v.w));
      *h = v;
      if (out) *reinterpret_cast<float4*>(post + (size_t)r * Np + c) = v;
    }
    __syncthreads();
  }
  const int* L = plan.layer[l0 + nl - 1];
  const int Kp = L[0], Np = L[1], G = it[9], SW = it[10], nslab = it[11];
  const int ldo = SW + 4, tgt = 1 - src, K = it[8];
  const bool inv = it[2] != 0, spline = it[0] == K_SPLINE;
  const float* b = Wk + L[4];
  float* pre = save ? scr.at(L[5] + Kp, Np) : nullptr;
  float* O = ring;
  for (int s = 0; s < nslab; ++s) {
    acc.zero();
    tile_product<MF, WM>(acc, H, ldh, Kp / 8, Wk + L[2], Np / 8, 0,
                         s * SW / 8, SW / 8, ring);
    for_acc<MF, WM>(acc, SW / 8, [&](int r, int c, float v) {
      O[r * ldo + c] = v + b[s * SW + c];
    });
    __syncthreads();
    if (save) {
      store_rows(pre + s * SW, Np, O, ldo, SW, scr.nvalid);
      if (!epi) __syncthreads();  // the next pass refills the ring
    }
    if (!epi) continue;
    const int j0 = s * G, gs = min(G, da - j0);
    for (int e = threadIdx.x; e < TM * gs; e += blockDim.x) {
      const int r = e / gs, jj = e - r * gs;
      const int idx = r * d + tgt * da + j0 + jj;
      float el;
      const float y =
          spline ? spline_fwd(S[idx], O + r * ldo, G, jj, K, itf[1], inv,
                              shift, &el)
                 : affine_fwd(S[idx], O + r * ldo, G, jj, itf[0], inv, &el);
      S[idx] = y;
      if (Lel) Lel[idx] += el;
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------------
// B4: replaces _fused_coupling_impl (ops/pallas/coupling.py:677-716).
// Shared memory, in floats: the ring (Geo::RING), S (TM x d) the state, Lel
// (TM x d) the per-element ladj terms, H (TM x ldh). Persistent grid-stride
// loop over tiles of TM rows.
template <int MF, int WM>
__global__ void __launch_bounds__(32 * ENF_WARPS, 1)
    coupling_fwd_kernel(const float* __restrict__ x, float* __restrict__ y,
                        float* __restrict__ ladj,
                        const float* __restrict__ Wk,
                        const float* __restrict__ P,
                        const __grid_constant__ CPlan plan, long long n,
                        int d, int ldh, float* scratch, float* svs,
                        float shift) {
  using Gm = Geo<MF, WM>;
  constexpr int TM = Gm::TM;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* S = ring + Gm::RING;
  float* Lel = S + TM * d;
  float* H = Lel + TM * d;
  const int da = d / 2;
  const long long ntiles = (n + TM - 1) / TM;
  for (long long ti = blockIdx.x; ti < ntiles; ti += gridDim.x) {
    const long long r0 = ti * TM;
    const int ns = (int)min((long long)TM, n - r0);
    const ScrRows scr{scratch, n, r0, ns};
    for (int e = threadIdx.x; e < TM * d; e += blockDim.x) {
      S[e] = e < ns * d ? x[r0 * d + e] : 0.f;
      Lel[e] = 0.f;
    }
    __syncthreads();
    for (int i = 0, coff = 0; i < plan.n_items; ++i) {
      const int* it = plan.item[i];
      if (svs) {  // the stage's input as B5's sweep keeps it
        const bool el = it[0] == K_ELEM;
        const int w = el ? d : da, c0 = el ? 0 : (1 - it[1]) * da;
        float* dst = svs + n * coff + r0 * w;
        for (int e = threadIdx.x; e < ns * w; e += blockDim.x) {
          const int r = e / w;
          dst[e] = S[r * d + c0 + e - r * w];
        }
        coff += w;
      }
      if (it[0] == K_ELEM) {
        const int code = it[6], slot = it[7];
        for (int e = threadIdx.x; e < TM * d; e += blockDim.x) {
          float el;
          S[e] = stage_fwd(code, S[e], P, slot, d, e % d, &el);
          Lel[e] += el;
        }
        __syncthreads();
      } else {
        coupling_fwd_tile<MF, WM>(plan, it, plan.itemf[i], S, Lel, d, H, ldh,
                                  ring, Wk, scr, true, shift);
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
// (ops/pallas/coupling.py:616-674). For the `rows` rows of one chunk: gx
// from gy (physical lane order) and gl; every conditioner layer's input
// h_in and pre-activation cotangent g_pre into the layer-major scratch; per
// block sums of the elementwise-parameter cotangents into p_part (grid,
// n_pslots * d). Shared memory, in floats: the ring, SV what the reverse
// sweep needs of each stage's input (an elementwise stage's whole input,
// TM x d; a coupling's target half, TM x d/2), SC (TM x d) the state during
// the recompute and then the running cotangent, GL (TM) the ladj
// cotangents, H (TM x ldh; in the reverse sweep it also holds each slab),
// PACC (n_pslots x d).
template <int MF, int WM>
__global__ void __launch_bounds__(32 * ENF_WARPS, 1)
    coupling_bwd_kernel(const float* __restrict__ x,
                        const float* __restrict__ gy,
                        const float* __restrict__ gl,
                        float* __restrict__ gx, const float* __restrict__ Wk,
                        const float* __restrict__ P,
                        const __grid_constant__ CPlan plan, long long rows,
                        int d, int ldh, int n_pslots, float* scratch,
                        const float* __restrict__ svs,
                        float* __restrict__ p_part, float shift) {
  using Gm = Geo<MF, WM>;
  constexpr int TM = Gm::TM;
  extern __shared__ __align__(16) float smem[];
  const int da = d / 2;
  const int TD = TM * d;
  const int ni = plan.n_items;
  int sv_len = 0;
  for (int i = 0; i < ni; ++i)
    sv_len += plan.item[i][0] == K_ELEM ? TD : TM * da;
  float* ring = smem;
  float* SV = ring + Gm::RING;
  float* SC = SV + sv_len;
  float* GL = SC + TD;
  float* H = GL + TM;
  float* PACC = H + TM * ldh;
  for (int q = threadIdx.x; q < n_pslots * d; q += blockDim.x) PACC[q] = 0.f;
  Acc<MF> acc;

  const long long ntiles = (rows + TM - 1) / TM;
  for (long long ti = blockIdx.x; ti < ntiles; ti += gridDim.x) {
    const long long r0 = ti * TM;
    const int ns = (int)min((long long)TM, rows - r0);
    const ScrRows scr{scratch, rows, r0, ns};
    for (int e = threadIdx.x; e < TD; e += blockDim.x)
      SC[e] = e < ns * d ? x[r0 * d + e] : 0.f;
    for (int r = threadIdx.x; r < TM; r += blockDim.x)
      GL[r] = r < ns ? gl[r0 + r] : 0.f;
    __syncthreads();

    // The stage inputs B4 stored, or the forward: what the reverse sweep
    // needs of each stage's input saved to SV, the conditioners' rows to
    // the scratch.
    for (int i = 0, off = 0, coff = 0; svs && i < ni; ++i) {
      const int w = plan.item[i][0] == K_ELEM ? d : da;
      const float* src = svs + rows * coff + r0 * w;
      for (int e = threadIdx.x; e < TM * w; e += blockDim.x)
        SV[off + e] = e < ns * w ? src[e] : 0.f;
      off += TM * w;
      coff += w;
    }
    for (int i = 0, off = 0; !svs && i < ni; ++i) {
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
        for (int e = threadIdx.x; e < TM * da; e += blockDim.x) {
          const int r = e / da, j = e - r * da;
          sv[e] = SC[r * d + tgt * da + j];
        }
        coupling_fwd_tile<MF, WM>(plan, it, plan.itemf[i], SC, nullptr, d, H,
                                  ldh, ring, Wk, scr, i + 1 < ni, shift);
        off += TM * da;
      }
    }

    float* CY = SC;
    for (int e = threadIdx.x; e < TD; e += blockDim.x)
      CY[e] = e < ns * d ? gy[r0 * d + e] : 0.f;
    __syncthreads();

    // Reverse sweep of the hand-derived adjoints.
    for (int i = ni - 1, off = sv_len; i >= 0; --i) {
      const int* it = plan.item[i];
      off -= it[0] == K_ELEM ? TD : TM * da;
      const float* cur = SV + off;
      if (it[0] == K_ELEM) {
        // One thread per lane, rows in order: each PACC entry has one owner.
        const int code = it[6], slot = it[7], np = n_params(code);
        for (int k = threadIdx.x; k < d; k += blockDim.x) {
          float a4[4] = {0.f, 0.f, 0.f, 0.f};
          for (int r = 0; r < ns; ++r) {
            float g[4];
            CY[r * d + k] = stage_bwd(code, cur[r * d + k], P, slot, d, k,
                                      CY[r * d + k], GL[r], g);
            for (int q = 0; q < np; ++q) a4[q] += g[q];
          }
          for (int q = 0; q < np; ++q) PACC[(slot + q) * d + k] += a4[q];
        }
        __syncthreads();
        continue;
      }
      const int src = it[1], tgt = 1 - src, act = it[3], nl = it[4],
                l0 = it[5], K = it[8], G = it[9], SW = it[10],
                nslab = it[11];
      const bool inv = it[2] != 0, spline = it[0] == K_SPLINE;
      const int ldo = SW + 4;
      const int* LL = plan.layer[l0 + nl - 1];
      const int KpL = LL[0], NpL = LL[1];
      float* gL = scr.at(LL[5] + KpL, NpL);
      float* O = H;
      // Each slab: the conditioner output from the scratch, the adjoint in
      // place, its cotangent back to the scratch in f32 (db sums it).
      for (int s = 0; s < nslab; ++s) {
        load_rows<TM>(O, ldo, gL + s * SW, NpL, SW, ns);
        const int j0 = s * G, gs = min(G, da - j0);
        for (int e = threadIdx.x; e < TM * gs; e += blockDim.x) {
          const int r = e / gs, jj = e - r * gs;
          const int idx = r * d + tgt * da + j0 + jj;
          float* h = O + r * ldo;
          const float xv = cur[r * da + j0 + jj];
          CY[idx] = spline ? spline_bwd(xv, h, G, jj, K, plan.itemf[i][1],
                                        inv, shift, CY[idx], GL[r], h)
                           : affine_bwd(xv, h, G, jj, plan.itemf[i][0], inv,
                                        CY[idx], GL[r], h);
        }
        __syncthreads();
        store_rows(gL + s * SW, NpL, O, ldo, SW, ns);
        __syncthreads();
      }
      // dh = g_pre W^T of the last layer, accumulated over the slabs, on
      // g_pre rounded to TF32 (tile_product's first barrier orders it).
      acc.zero();
      for (int s = 0; s < nslab; ++s) {
        load_rows<TM>(O, ldo, gL + s * SW, NpL, SW, ns);
        for (int e = threadIdx.x; e < TM * SW; e += blockDim.x) {
          const int r = e / SW, c = e - r * SW;
          O[r * ldo + c] = tf32r(O[r * ldo + c]);
        }
        tile_product<MF, WM>(acc, O, ldo, SW / 8, Wk + LL[3], KpL / 8,
                             s * SW / 8, 0, KpL / 8, ring);
      }
      // Down the layers: acc holds the cotangent of layer l's input.
      for (int l = nl - 1;; --l) {
        const int Kp = plan.layer[l0 + l][0];
        if (l == 0) {
          for_acc<MF, WM>(acc, Kp / 8, [&](int r, int c, float v) {
            if (c < da) CY[r * d + src * da + c] += v;
          });
          __syncthreads();
          break;
        }
        const int* Lp = plan.layer[l0 + l - 1];  // its Np is Kp
        float* gp = scr.at(Lp[5] + Lp[0], Kp);   // its pre-activation
        // The cotangent into H, then the adjoint in a pass over H with the
        // accumulators dead, reading the pre-activation in 16-byte loads,
        // four per thread in flight; g_pre over it in the scratch in f32,
        // and rounded to TF32 into H for the product.
        for_acc<MF, WM>(acc, Kp / 8,
                        [&](int r, int c, float v) { H[r * ldh + c] = v; });
        __syncthreads();
        const int q = Kp / 4, total = TM * q;
        for (int i0 = threadIdx.x; i0 < total; i0 += 4 * blockDim.x) {
          float4 p[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = i0 + u * blockDim.x, r = i / q, c = (i - r * q) * 4;
            p[u] = i < total && r < ns
                       ? __ldcg(reinterpret_cast<const float4*>(
                             gp + (size_t)r * Kp + c))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = i0 + u * blockDim.x, r = i / q, c = (i - r * q) * 4;
            if (i >= total) break;
            float4* h = reinterpret_cast<float4*>(H + r * ldh + c);
            float4 g = *h;
            g.x = act_bwd(act, p[u].x, g.x);
            g.y = act_bwd(act, p[u].y, g.y);
            g.z = act_bwd(act, p[u].z, g.z);
            g.w = act_bwd(act, p[u].w, g.w);
            if (r < ns)
              *reinterpret_cast<float4*>(gp + (size_t)r * Kp + c) = g;
            *h = make_float4(tf32r(g.x), tf32r(g.y), tf32r(g.z), tf32r(g.w));
          }
        }
        __syncthreads();
        acc.zero();
        tile_product<MF, WM>(acc, H, ldh, Kp / 8, Wk + Lp[3], Lp[0] / 8, 0, 0,
                             Lp[0] / 8, ring);
      }
    }

    for (int e = threadIdx.x; e < ns * d; e += blockDim.x) gx[r0 * d + e] = CY[e];
    __syncthreads();
  }
  for (int q = threadIdx.x; q < n_pslots * d; q += blockDim.x)
    p_part[(size_t)blockIdx.x * n_pslots * d + q] = PACC[q];
}

// B5 (b): dW = sum_r h_in[r]^T g_pre[r] on the tensor cores and db =
// sum_r g_pre[r] for every layer, over the `rows` scratch rows of one
// chunk, split into nsplit fixed row ranges (blockIdx.y). A block owns a
// 128 x 128 tile of a layer's (Kp, Np) dW; 8 warps of 64 x 32 (4 x 4 m16n8
// tiles). 32 rows of h_in and of g_pre per ring stage (3 stages, 16-byte
// cp.async, rows of 136 floats so both fragments read conflict-free). h_in
// is TF32 already; g_pre is f32 and rounded as its fragments are read, so
// that the blocks of the first row of tiles sum it in f32 for db.
// Writes w_part[split * w_len + natural offset + k * Np + n], b after W.
// blockIdx.x runs over the tiles of every layer, so the blocks resident
// together are the tiles of one split, which stream the same rows.
__global__ void __launch_bounds__(256)
    coupling_dw_kernel(const float* __restrict__ scratch,
                       const __grid_constant__ CPlan plan, long long rows,
                       int nsplit, float* __restrict__ w_part,
                       long long w_len) {
  extern __shared__ __align__(16) float sm[];
  constexpr int LD = ENF_DW_LD, RB = ENF_DW_RB;
  constexpr int STAGE = 2 * RB * LD;
  int t = blockIdx.x, l = 0, tn = 1;
  for (; l < plan.n_layers; ++l) {
    const int Kp = plan.layer[l][0], Np = plan.layer[l][1];
    tn = (Np + ENF_DW_TILE - 1) / ENF_DW_TILE;
    const int tiles = (Kp + ENF_DW_TILE - 1) / ENF_DW_TILE * tn;
    if (t < tiles) break;
    t -= tiles;
  }
  if (l >= plan.n_layers) return;
  const int* L = plan.layer[l];
  const int Kp = L[0], Np = L[1];
  const int m0 = (t / tn) * ENF_DW_TILE, n0 = (t % tn) * ENF_DW_TILE;
  const float* hin = scratch + rows * L[5];
  const float* gp = scratch + rows * (L[5] + Kp);
  const int s = blockIdx.y;
  const long long rb = rows * s / nsplit, re = rows * (s + 1) / nsplit;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, tq = lane & 3;
  const bool bias = m0 == 0 && threadIdx.x < ENF_DW_TILE;
  const long long nst = (re - rb + RB - 1) / RB;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  float colsum = 0.f;
  auto load = [&](long long st) {
    float* As = sm + (st % ENF_RING) * STAGE;
    float* Bs = As + RB * LD;
    const long long r = rb + st * RB;
    for (int i = threadIdx.x; i < RB * 32; i += blockDim.x) {
      const int rr = i >> 5, c = (i & 31) * 4;
      const long long row = r + rr;
      const bool ok = row < re;
      const bool ka = ok && m0 + c < Kp, kb = ok && n0 + c < Np;
      cp_async16(As + rr * LD + c, ka ? hin + row * Kp + m0 + c : hin,
                 ka ? 16 : 0);
      cp_async16(Bs + rr * LD + c, kb ? gp + row * Np + n0 + c : gp,
                 kb ? 16 : 0);
    }
  };
#pragma unroll
  for (int st = 0; st < ENF_RING - 1; ++st) {
    if (st < nst) load(st);
    cp_async_commit();
  }
  for (long long st = 0; st < nst; ++st) {
    cp_async_wait<ENF_RING - 2>();
    __syncthreads();
    if (st + ENF_RING - 1 < nst) load(st + ENF_RING - 1);
    cp_async_commit();
    const float* As = sm + (st % ENF_RING) * STAGE;
    const float* Bs = As + RB * LD;
#pragma unroll
    for (int ks = 0; ks < RB; ks += 8) {
      const float* a0 = As + (ks + tq) * LD + wm * 64 + g;
      const float* a4 = a0 + 4 * LD;
      const float* b0 = Bs + (ks + tq) * LD + wn * 32 + g;
      const float* b4 = b0 + 4 * LD;
      unsigned a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i][0] = __float_as_uint(a0[i * 16]);
        a[i][1] = __float_as_uint(a0[i * 16 + 8]);
        a[i][2] = __float_as_uint(a4[i * 16]);
        a[i][3] = __float_as_uint(a4[i * 16 + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float bx = tf32r(b0[j * 8]), by = tf32r(b4[j * 8]);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_tf32(acc[i][j], a[i], bx, by);
      }
    }
    if (bias)
      for (int rr = 0; rr < RB; ++rr) colsum += Bs[rr * LD + threadIdx.x];
  }
  cp_async_wait<0>();
  float* out = w_part + (size_t)s * w_len + L[6];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = m0 + wm * 64 + i * 16 + g + (q >> 1) * 8;
        const int nn = n0 + wn * 32 + j * 8 + 2 * tq + (q & 1);
        if (m < Kp && nn < Np) out[(size_t)m * Np + nn] = acc[i][j][q];
      }
  if (bias && n0 + (int)threadIdx.x < Np)
    out[(size_t)Kp * Np + n0 + threadIdx.x] = colsum;
}

// ------------------------------------------------------------------
// C interface. Each function launches on `stream`, does not synchronize, and
// returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a plan or shape the kernels do not take.

static int make_cplan(CPlan* p, const int* si, const float* sf, int n_items,
                      const int* li, int n_layers) {
  if (n_items < 1 || n_items > ENF_CMAX_STAGES || n_layers < 1 ||
      n_layers > ENF_CMAX_LAYERS)
    return 1;
  *p = CPlan{};
  p->n_items = n_items;
  p->n_layers = n_layers;
  for (int l = 0; l < n_layers; ++l) {
    for (int f = 0; f < 7; ++f) p->layer[l][f] = li[l * 7 + f];
    if (p->layer[l][0] < 8 || p->layer[l][0] % 8 || p->layer[l][1] < 8 ||
        p->layer[l][1] % 8)
      return 1;
  }
  for (int i = 0; i < n_items; ++i) {
    for (int f = 0; f < 12; ++f) p->item[i][f] = si[i * 12 + f];
    p->itemf[i][0] = sf[i * 2];
    p->itemf[i][1] = sf[i * 2 + 1];
    const int* it = p->item[i];
    if (it[0] != K_ELEM &&
        (it[4] < 1 || it[5] < 0 || it[5] + it[4] > n_layers || it[9] < 1 ||
         it[10] < 8 || it[10] % 8 || it[11] < 1 ||
         it[10] * it[11] != p->layer[it[5] + it[4] - 1][1]))
      return 1;
  }
  return 0;
}

// Whether the row tile takes the plan: every layer input and hidden output
// within one pass, every slab within the ring and the activation buffer.
template <int MF, int WM>
static bool tile_ok(const CPlan& p, int d, int ldh) {
  using G = Geo<MF, WM>;
  if (d < 2 || d % 2 || ldh % 8 != 4) return false;
  for (int i = 0; i < p.n_items; ++i) {
    const int* it = p.item[i];
    if (it[0] == K_ELEM) continue;
    if (p.layer[it[5]][0] < d / 2) return false;
    if (G::TM * (it[10] + 4) > G::RING || it[10] + 4 > ldh) return false;
    for (int l = it[5]; l < it[5] + it[4]; ++l) {
      if (p.layer[l][0] > G::PASS || p.layer[l][0] + 4 > ldh) return false;
      if (l + 1 < it[5] + it[4] &&
          (p.layer[l][1] > G::PASS || p.layer[l][1] != p.layer[l + 1][0]))
        return false;
    }
  }
  return true;
}

template <int MF, int WM>
static int launch_fwd(const float* x, float* y, float* ladj, const float* Wk,
                      const float* P, const CPlan& plan, long long n, int d,
                      int ldh, float* scratch, float* svs, int smem, int grid,
                      float shift, cudaStream_t stream) {
  using G = Geo<MF, WM>;
  const long long need =
      4LL * (G::RING + (long long)G::TM * (2 * d + ldh));
  if (!tile_ok<MF, WM>(plan, d, ldh) || need > smem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      coupling_fwd_kernel<MF, WM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  coupling_fwd_kernel<MF, WM><<<grid, 32 * ENF_WARPS, smem, stream>>>(
      x, y, ladj, Wk, P, plan, n, d, ldh, scratch, svs, shift);
  return (int)cudaGetLastError();
}

extern "C" int enf_coupling_fwd(const float* x, float* y, float* ladj,
                                const float* Wk, const float* P,
                                const int* si, const float* sf, int n_items,
                                const int* li, int n_layers, long long n,
                                int d, int ldh, int tm, float* scratch,
                                float* svs, int smem, int grid, float shift,
                                void* stream) {
  CPlan plan;
  if (make_cplan(&plan, si, sf, n_items, li, n_layers))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (tm == 64)
    return launch_fwd<2, 2>(x, y, ladj, Wk, P, plan, n, d, ldh, scratch, svs,
                            smem, grid, shift, s);
  if (tm == 16)
    return launch_fwd<1, 1>(x, y, ladj, Wk, P, plan, n, d, ldh, scratch, svs,
                            smem, grid, shift, s);
  return (int)cudaErrorInvalidValue;
}

template <int MF, int WM>
static int launch_bwd(const float* x, const float* gy, const float* gl,
                      float* gx, const float* Wk, const float* P,
                      const CPlan& plan, long long rows, int d, int ldh,
                      int smem, int grid, int n_pslots, float* scratch,
                      const float* svs, float* p_part, float shift,
                      cudaStream_t stream) {
  using G = Geo<MF, WM>;
  long long sv_row = 0;  // floats of SV per row
  for (int i = 0; i < plan.n_items; ++i)
    sv_row += plan.item[i][0] == K_ELEM ? d : d / 2;
  const long long need =
      4LL * (G::RING + (long long)G::TM * (sv_row + d + 1 + ldh) +
             (long long)n_pslots * d);
  if (!tile_ok<MF, WM>(plan, d, ldh) || need > smem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      coupling_bwd_kernel<MF, WM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  coupling_bwd_kernel<MF, WM><<<grid, 32 * ENF_WARPS, smem, stream>>>(
      x, gy, gl, gx, Wk, P, plan, rows, d, ldh, n_pslots, scratch, svs,
      p_part, shift);
  return (int)cudaGetLastError();
}

extern "C" int enf_coupling_bwd(const float* x, const float* gy,
                                const float* gl, float* gx, const float* Wk,
                                const float* P, const int* si,
                                const float* sf, int n_items, const int* li,
                                int n_layers, long long rows, int d, int ldh,
                                int tm, int smem, int grid, int n_pslots,
                                float* scratch, const float* svs,
                                float* p_part, float shift, void* stream) {
  CPlan plan;
  if (make_cplan(&plan, si, sf, n_items, li, n_layers))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (tm == 64)
    return launch_bwd<2, 2>(x, gy, gl, gx, Wk, P, plan, rows, d, ldh, smem,
                            grid, n_pslots, scratch, svs, p_part, shift, s);
  if (tm == 16)
    return launch_bwd<1, 1>(x, gy, gl, gx, Wk, P, plan, rows, d, ldh, smem,
                            grid, n_pslots, scratch, svs, p_part, shift, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int enf_coupling_dw(const float* scratch, const int* li,
                               int n_layers, long long rows, int nsplit,
                               float* w_part, long long w_len, int smem,
                               void* stream) {
  CPlan plan = CPlan{};
  if (n_layers < 1 || n_layers > ENF_CMAX_LAYERS || nsplit < 1 ||
      smem < 4 * ENF_RING * 2 * ENF_DW_RB * ENF_DW_LD)
    return (int)cudaErrorInvalidValue;
  plan.n_layers = n_layers;
  int tiles = 0;
  for (int l = 0; l < n_layers; ++l) {
    for (int f = 0; f < 7; ++f) plan.layer[l][f] = li[l * 7 + f];
    const int Kp = plan.layer[l][0], Np = plan.layer[l][1];
    if (Kp % 8 || Np % 8) return (int)cudaErrorInvalidValue;
    tiles += (Kp + ENF_DW_TILE - 1) / ENF_DW_TILE *
             ((Np + ENF_DW_TILE - 1) / ENF_DW_TILE);
  }
  cudaError_t err = cudaFuncSetAttribute(
      coupling_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(tiles, nsplit);
  coupling_dw_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
      scratch, plan, rows, nsplit, w_part, w_len);
  return (int)cudaGetLastError();
}
