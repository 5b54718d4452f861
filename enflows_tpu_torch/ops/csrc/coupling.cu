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
// (Kp, Np), K and N padded to multiples of 8 (16 for bf16 products) with
// zeros, and the offsets of its packed W and W^T (rounded to TF32, or to
// bf16 two to a word) and its bias in one kernel buffer, Permutes already
// absorbed. The state of a sample stays in physical lane order as two
// halves [0, d/2) and [d/2, d). The last layer is lane-grouped: slab s
// (width SW, a multiple of 8) holds parameter p of its half-lane jj at
// column s * SW + p * G + jj. Elementwise stages take per-lane parameter
// vectors, slot q at P[q*d .. q*d+d), and run the stage bodies of
// stages.cuh that B1-B3 use.
//
// Precision. Every conditioner product runs on the tensor cores with f32
// accumulation: TF32 operands, the counterpart of the reference's
// DEFAULT-precision matmuls (one bf16 pass of the MXU; TF32 keeps 10
// mantissa bits to bf16's 7), or, for a coupling with compute_dtype
// "bfloat16", bf16 operands as the reference's _mm_bf16 (:419-446). Weights
// are rounded once by the wrapper, activations where they are written
// (TF32 to nearest, ties away from zero; bf16 to nearest even), so the
// products convert nothing. B5 keeps each pre-activation cotangent in f32
// in its scratch, so that db is an f32 sum as in the plain version, and
// rounds it where a product reads it (dh in the sweep, dW in
// coupling_dw_kernel), as _mm_bf16's backward rounds g. Biases,
// activations, epilogues, adjoints and ladj stay f32. bf16 storage (a flag
// per launch): x and gy are widened to f32 as they are read, y, ladj and
// gx rounded to nearest even as they are written; the saved rows and
// everything between stay f32.
//
// Two paths. The Hopper path (64-row tiles; below) takes every stack whose
// padded layer inputs, hidden outputs and slabs are at most 512 wide and
// whose state fits beside them in shared memory: the BASELINE stacks, the
// VI templates, every stack of the examples and the samplers. The wide
// path keeps the 16-row mma.sync kernels of the first tensor-core design
// (the *_wide kernels) for exactly the stacks the Hopper path cannot hold:
// wgmma takes 64 rows, and a 64-row tile's activation buffer at a width
// of 1024 (the (1024, 1024) stack the reference accepts) is 256 KB in f32,
// more than a block's 227 KB; so is its state at d = 256 with hidden 512
// (64 rows x (d state + 512 activations + 184 slab) x 4 B). Every stack
// the 64-row wgmma tile does not take runs there, as before.
//
// What bounds the Hopper path on an H100 (BASELINE: d=64, 4 couplings,
// (512, 512) gelu conditioners, n=2^17):
//   * the weight stream: the weights (5.0 / 10.5 MB affine / spline) fit
//     the 50 MB L2 but not a block's shared memory, so every 64-row tile
//     streams them once (10.2 / 21.5 GB from L2 a B4 at BASELINE, at some
//     4 TB/s 2.5 / 5.4 ms). Design: each k-step of each pass of W is one
//     contiguous run, packed in wgmma's shared-memory layout, that one
//     cp.async.bulk moves into a ring of mbarrier-tracked slots; one
//     producer thread keeps the ring full across products, couplings and
//     tiles. The stream still bounds B4: a 64-row tile's activations fill
//     half of shared memory, so no larger tile fits beside the ring, and a
//     2-CTA cluster sharing each stage by .multicast::cluster was slower
//     (its cross-CTA releases on every k-step cost more than the halved
//     L2 reads saved).
//   * the TF32 product rate (B4 326 / 687 GFLOP, 0.66 / 1.39 ms at 495
//     TFLOP/s; B5 twice that plus the recompute). Design: wgmma.mma_async
//     m64n64k8 TF32 / m64n64k16 bf16 from shared memory, two consumer
//     warpgroups each taking every other 64-column n-block of a pass of up
//     to 512 columns (128 f32 accumulators a thread, setmaxnreg giving the
//     consumers 240 registers and the producer warpgroup 24), issued
//     without branches so the tensor cores take a k-step's products back
//     to back.
//   * the epilogues (bias and activation of 64 x 512 values a hidden
//     layer; B5 the activation's adjoint against the stored pre-activation
//     from device memory): staged through shared memory and run in rolled
//     loops that take 8 rows of a column at a time and issue all their
//     loads first.
//   * the scratch bytes of B5: each layer's input and pre-activation
//     cotangent per row (34.3 / 45.1 KB per row) go to device memory for
//     the dW reduction, in the layout coupling_dw_kernel's products read
//     (the batch as K): its blocks, layer by layer and split by split, copy
//     32 rows of a 128 x 256 tile's operands as two contiguous runs.
//
// B4. A block owns a tile of 64 rows and keeps in shared memory the state
// S (64 x d), the per-row ladj sums, the activation buffer H (the
// products' A, K-major) and O, one slab of the last layer. A coupling
// copies its src half into H (zero-padded to Kp, rounded); each hidden
// layer accumulates its whole output in the two warpgroups' registers,
// then bias and activation are written back into H in place; the last
// layer runs slab by slab into O and the slab's epilogue updates the
// target half of S at once, its ladj terms summed per row. Elementwise
// stages run four threads a row. Persistent grid-stride loop over tiles;
// the ragged last tile computes on zero rows, writes B5's rows for them
// (the arrays hold whole tiles) and stores nothing else.
//
// B5 (a) reads the stage inputs (a coupling's target half, an elementwise
// stage's whole input) from device memory: B4 wrote them in training, or
// B5 recomputes each tile's forward and writes them itself, with every
// layer's input and pre-activation into the scratch. The reverse sweep
// reads each slab of the conditioner output back, runs the hand-derived
// adjoint in place, writes g_pre, accumulates dh = g_pre W^T over the
// slabs (the same product on the packed W^T), applies the activation's
// adjoint against the stored pre-activation and walks down the layers.
// (b) coupling_dw_kernel forms dW = h_in^T g_pre and db = sum g_pre over
// fixed row splits. The splits and the wrapper's chunks are summed by the
// caller in a fixed order. No atomics anywhere: results are deterministic
// for a given grid. The elementwise-parameter cotangents are per-block
// sums (each lane owned by one thread), summed by the caller.
//
// The adjoints follow the torch functions _adjoint_activation,
// _adjoint_affine and _adjoint_spline of enflows_tpu_torch/ops/coupling.py
// line by line; the CPU tests hold those against autograd.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

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
// Layer fields: Kp, Np, packed W offset, packed W^T offset, bias offset
// (in 32-bit words of the kernel buffer), scratch column base (h_in, then
// g_pre at + Kp), natural dW offset, bf16 products (1) or TF32 (0).
struct CPlan {
  int n_items;
  int n_layers;
  int item[ENF_CMAX_STAGES][12];
  float itemf[ENF_CMAX_STAGES][2];  // max_log_scale, bound
  int layer[ENF_CMAX_LAYERS][8];
};

// x, y, ladj, gy, gl and gx in their storage type, by a flag per launch.
__device__ __forceinline__ float ld_io(const void* p, long long i, bool bf) {
  return bf ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
            : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st_io(void* p, long long i, float v,
                                      bool bf) {
  if (bf)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

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
// Operand rounding (both paths), and the wide path's 16-row tile products
// on mma.sync (TF32 m16n8k8, bf16 m16n8k16), its weights packed in their
// B-fragment order by the wrapper (``_pack``, ``_pack_bf16``).

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

// Round to bf16, to nearest even, kept in f32.
__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Two f32 values as one bf16x2 word, rounded to nearest even: lo in the
// lower half (the lower k or column of an mma fragment).
__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  unsigned u;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(u) : "f"(hi), "f"(lo));
  return u;
}

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The rounding of a layer's operands: bf16 or TF32.
__device__ __forceinline__ float oprnd(float v, bool bf) {
  return bf ? bf16r(v) : tf32r(v);
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

// tile_product with bf16 operands: ksteps 16-deep k-steps from kk0 of a
// matrix packed for m16n8k16 (two bf16 a word, 64 words a fragment, so the
// ring and its pieces are tile_product's). A fragments are packed from the
// f32 rows of A (row stride lda even) by cvt.rn.bf16x2.f32: row g of a
// fragment holds columns 2t, 2t + 1 and 2t + 8, 2t + 9.
template <int MF, int WM>
__device__ void tile_product_bf16(Acc<MF>& acc, const float* A, int lda,
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
  const float* arow = A + (wm * MF * 16 + g) * lda + 2 * t;
  for (int kk = 0; kk < ksteps; ++kk) {
    cp_async_wait<ENF_RING - 2>();
    __syncthreads();  // stage kk landed; stage kk - 1 is read by everyone
    if (kk + ENF_RING - 1 < ksteps) load(kk + ENF_RING - 1);
    cp_async_commit();
    const unsigned* bs = reinterpret_cast<const unsigned*>(
                             ring + (kk % ENF_RING) * 8 * G::PASS) +
                         lane * 2;
    unsigned a[MF][4];
#pragma unroll
    for (int m = 0; m < MF; ++m) {
      const float* p = arow + m * 16 * lda + kk * 16;
      const float2 v0 = *reinterpret_cast<const float2*>(p);
      const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * lda);
      const float2 v2 = *reinterpret_cast<const float2*>(p + 8);
      const float2 v3 = *reinterpret_cast<const float2*>(p + 8 * lda + 8);
      a[m][0] = bf16x2(v0.x, v0.y);
      a[m][1] = bf16x2(v1.x, v1.y);
      a[m][2] = bf16x2(v2.x, v2.y);
      a[m][3] = bf16x2(v3.x, v3.y);
    }
#pragma unroll
    for (int j = 0; j < ENF_NF; ++j) {
      const int tile = j * G::WN + wn;
      if (tile < ntiles) {
        const uint2 b = *reinterpret_cast<const uint2*>(bs + tile * 64);
#pragma unroll
        for (int m = 0; m < MF; ++m) mma_bf16(acc.v[m][j], a[m], b.x, b.y);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// acc += A times rows [k0, k0 + kdim) (a multiple of the layer's k-step,
// 8 TF32 or 16 bf16) and n-tiles [nt0, nt0 + ntiles) of a packed matrix,
// on the layer's path: bf16 operands where `bf`, TF32 otherwise.
template <int MF, int WM>
__device__ __forceinline__ void tile_mm(bool bf, Acc<MF>& acc,
                                        const float* A, int lda, int kdim,
                                        const float* __restrict__ Bp,
                                        int ntot, int k0, int nt0,
                                        int ntiles, float* ring) {
  if (bf)
    tile_product_bf16<MF, WM>(acc, A, lda, kdim / 16, Bp, ntot, k0 / 16, nt0,
                              ntiles, ring);
  else
    tile_product<MF, WM>(acc, A, lda, kdim / 8, Bp, ntot, k0 / 8, nt0,
                         ntiles, ring);
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
__device__ void coupling_fwd_tile_wide(const CPlan& plan, const int* it,
                                  const float* itf, float* S, float* Lel,
                                  int d, float* H, int ldh, float* ring,
                                  const float* __restrict__ Wk,
                                  const ScrRows& scr, bool epi, float shift) {
  constexpr int TM = Geo<MF, WM>::TM;
  const int da = d / 2, src = it[1], act = it[3], nl = it[4], l0 = it[5];
  const bool save = scr.base != nullptr;
  const bool bf = plan.layer[l0][7] != 0;  // the coupling's products
  {
    const int Kp = plan.layer[l0][0];
    float* hin = save ? scr.at(plan.layer[l0][5], Kp) : nullptr;
    for (int e = threadIdx.x; e < TM * Kp; e += blockDim.x) {
      const int r = e / Kp, k = e - r * Kp;
      const float v = k < da ? oprnd(S[r * d + src * da + k], bf) : 0.f;
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
    tile_mm<MF, WM>(bf, acc, H, ldh, Kp, Wk + L[2], Np / 8, 0, 0, Np / 8,
                    ring);
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
      v.x = oprnd(act_fwd(act, v.x), bf);
      v.y = oprnd(act_fwd(act, v.y), bf);
      v.z = oprnd(act_fwd(act, v.z), bf);
      v.w = oprnd(act_fwd(act, v.w), bf);
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
    tile_mm<MF, WM>(bf, acc, H, ldh, Kp, Wk + L[2], Np / 8, 0, s * SW / 8,
                    SW / 8, ring);
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
// loop over tiles of TM rows. x, y and ladj in bf16 where `bfio`, else f32.
template <int MF, int WM>
__global__ void __launch_bounds__(32 * ENF_WARPS, 1)
    coupling_fwd_kernel_wide(const void* __restrict__ x, void* __restrict__ y,
                        void* __restrict__ ladj,
                        const float* __restrict__ Wk,
                        const float* __restrict__ P,
                        const __grid_constant__ CPlan plan, long long n,
                        int d, int ldh, float* scratch, float* svs,
                        float shift, int bfio) {
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
      S[e] = e < ns * d ? ld_io(x, r0 * d + e, bfio) : 0.f;
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
        coupling_fwd_tile_wide<MF, WM>(plan, it, plan.itemf[i], S, Lel, d, H, ldh,
                                  ring, Wk, scr, true, shift);
      }
    }
    for (int e = threadIdx.x; e < ns * d; e += blockDim.x)
      st_io(y, r0 * d + e, S[e], bfio);
    for (int r = threadIdx.x; r < ns; r += blockDim.x) {
      float sum = 0.f;
      for (int k = 0; k < d; ++k) sum += Lel[r * d + k];
      st_io(ladj, r0 + r, sum, bfio);
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
// PACC (n_pslots x d). x, gy, gl and gx in bf16 where `bfio`, else f32.
template <int MF, int WM>
__global__ void __launch_bounds__(32 * ENF_WARPS, 1)
    coupling_bwd_kernel_wide(const void* __restrict__ x,
                        const void* __restrict__ gy,
                        const void* __restrict__ gl,
                        void* __restrict__ gx, const float* __restrict__ Wk,
                        const float* __restrict__ P,
                        const __grid_constant__ CPlan plan, long long rows,
                        int d, int ldh, int n_pslots, float* scratch,
                        const float* __restrict__ svs,
                        float* __restrict__ p_part, float shift, int bfio) {
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
      SC[e] = e < ns * d ? ld_io(x, r0 * d + e, bfio) : 0.f;
    for (int r = threadIdx.x; r < TM; r += blockDim.x)
      GL[r] = r < ns ? ld_io(gl, r0 + r, bfio) : 0.f;
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
        coupling_fwd_tile_wide<MF, WM>(plan, it, plan.itemf[i], SC, nullptr, d, H,
                                  ldh, ring, Wk, scr, i + 1 < ni, shift);
        off += TM * da;
      }
    }

    float* CY = SC;
    for (int e = threadIdx.x; e < TD; e += blockDim.x)
      CY[e] = e < ns * d ? ld_io(gy, r0 * d + e, bfio) : 0.f;
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
      const bool bf = plan.layer[l0][7] != 0;  // the coupling's products
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
      // g_pre rounded to TF32, or to bf16 for a bf16 layer (tile_product's
      // first barrier orders it). A bf16 slab is read at a depth SK padded
      // to 16 with zero columns, against W^T packed slab by slab at that
      // depth.
      const int SK = bf ? (SW + 15) / 16 * 16 : SW, ldk = SK + 4;
      acc.zero();
      for (int s = 0; s < nslab; ++s) {
        load_rows<TM>(O, ldk, gL + s * SW, NpL, SW, ns);
        for (int e = threadIdx.x; e < TM * SK; e += blockDim.x) {
          const int r = e / SK, c = e - r * SK;
          O[r * ldk + c] = c < SW ? oprnd(O[r * ldk + c], bf) : 0.f;
        }
        tile_mm<MF, WM>(bf, acc, O, ldk, SK, Wk + LL[3], KpL / 8, s * SK, 0,
                        KpL / 8, ring);
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
            *h = make_float4(oprnd(g.x, bf), oprnd(g.y, bf), oprnd(g.z, bf),
                             oprnd(g.w, bf));
          }
        }
        __syncthreads();
        acc.zero();
        tile_mm<MF, WM>(bf, acc, H, ldh, Kp, Wk + Lp[3], Lp[0] / 8, 0, 0,
                        Lp[0] / 8, ring);
      }
    }

    for (int e = threadIdx.x; e < ns * d; e += blockDim.x)
      st_io(gx, r0 * d + e, CY[e], bfio);
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
// that the blocks of the first row of tiles sum it in f32 for db. A bf16
// layer takes m16n8k16 over 16 rows at a time: h_in (bf16 already) and
// g_pre packed two rows to a word by cvt.rn.bf16x2.f32, g_pre rounded to
// nearest even there, as _mm_bf16's backward rounds its cotangent.
// Writes w_part[split * w_len + natural offset + k * Np + n], b after W.
// blockIdx.x runs over the tiles of every layer, so the blocks resident
// together are the tiles of one split, which stream the same rows.
__global__ void __launch_bounds__(256)
    coupling_dw_kernel_wide(const float* __restrict__ scratch,
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
  const bool bf = L[7] != 0;
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
    if (bf) {
#pragma unroll
      for (int ks = 0; ks < RB; ks += 16) {
        // Rows (batch) ks + 2 tq, + 1 and ks + 2 tq + 8, + 9.
        const float* a0 = As + (ks + 2 * tq) * LD + wm * 64 + g;
        const float* b0 = Bs + (ks + 2 * tq) * LD + wn * 32 + g;
        unsigned a[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* p = a0 + i * 16;
          a[i][0] = bf16x2(p[0], p[LD]);
          a[i][1] = bf16x2(p[8], p[LD + 8]);
          a[i][2] = bf16x2(p[8 * LD], p[9 * LD]);
          a[i][3] = bf16x2(p[8 * LD + 8], p[9 * LD + 8]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* p = b0 + j * 8;
          const unsigned bx = bf16x2(p[0], p[LD]);
          const unsigned by = bf16x2(p[8 * LD], p[9 * LD]);
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_bf16(acc[i][j], a[i], bx, by);
        }
      }
    } else {
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
// The Hopper path: 64-row tiles, wgmma fed by bulk copies into an
// mbarrier ring.
//
// A block is two consumer warpgroups (threads 0-255) and one producer
// warpgroup (256-383), which gives its registers to the consumers
// (setmaxnreg: 240 a consumer thread, 24 a producer thread). The consumers
// run every product, epilogue and elementwise pass and meet at named
// barrier 1 (256 threads); the producer never joins it. One producer
// thread walks the plan in the consumers' order and
// keeps the weight stages in flight: for each k-step of each product it
// waits until its ring slot is empty, arms the slot's full barrier with the
// stage's bytes and issues one cp.async.bulk of the stage, whose completion
// the barrier counts. The walk does not depend on the data, so the producer
// runs ahead across products, couplings and tiles as far as the ring lets
// it: the next product's and the next tile's first stages arrive while the
// consumers run an epilogue.
//
// Shared-memory operands are in wgmma's K-major canonical layout without
// swizzle: core matrices of 8 rows x 16 bytes (4 TF32 or 8 bf16 values of
// K), each 128 contiguous bytes, K-adjacent ones 128 bytes apart (the
// descriptor's leading byte offset), 8-row groups a stride apart (its
// stride byte offset). A core matrix is read as one 128-byte row of the
// banks, so no swizzle is needed to avoid conflicts. A k-step is 32 bytes
// of K: wgmma m64n64k8 TF32 or m64n64k16 bf16.

#define ENF_TM 64           // rows per tile of B4 / B5
#define ENF_CONS 256        // consumer threads: two warpgroups
#define ENF_THREADS 384     // and the producer warpgroup
#define ENF_NBW 4           // 64-column n-blocks per warpgroup: a pass <= 512
#define ENF_BARS 512        // bytes for the ring's barriers
#define ENF_MAX_RING 16
#define ENF_DWM 128         // dW output tile: rows (h_in columns)
#define ENF_DWN 256         // and columns (g_pre columns)
#define ENF_DWR 32          // batch rows per dW stage
#define ENF_DW_RING 4
#define ENF_DW_STAGE (4 * ENF_DWR * (ENF_DWM + ENF_DWN))   // 49152 bytes

typedef unsigned long long u64;

__device__ __forceinline__ unsigned saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(u64* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(u64* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(saddr(b)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(u64* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(b))
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed. A
// wait of more than 2^35 clocks (some 20 s) is a fault of the ring's
// protocol, and traps rather than hangs the card.
__device__ __forceinline__ void mbar_wait(u64* b, unsigned parity) {
  const unsigned a = saddr(b);
  long long t0 = -1;
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 < 0)
      t0 = clock64();
    else if (clock64() - t0 > (1LL << 35))
      __trap();
  }
}

// `bytes` (a multiple of 16) from device memory to shared memory, counted
// by the barrier's transaction count when they land.
__device__ __forceinline__ void bulk_g2s(unsigned dst, const void* src,
                                         unsigned bytes, u64* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(saddr(bar))
      : "memory");
}

// Generic-proxy writes to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The consumers' barrier (the producer warp never arrives at it).
__device__ __forceinline__ void csync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// The matrix descriptor of a K-major operand without swizzle.
__device__ __forceinline__ u64 gdesc(unsigned addr, unsigned lbo,
                                     unsigned sbo) {
  return (u64)((addr & 0x3FFFF) >> 4) | ((u64)((lbo >> 4) & 0x3FFF) << 16) |
         ((u64)((sbo >> 4) & 0x3FFF) << 32);
}

#define ENF_D32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define ENF_ACC32(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (64 x 64, f32) += A (64 x 8, TF32) B (8 x 64, TF32).
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], u64 a, u64 b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " ENF_D32
      ", %32, %33, p, 1, 1;\n}\n"
      : ENF_ACC32(d)
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, bf16) B (16 x 64, bf16).
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], u64 a, u64 b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ENF_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ENF_ACC32(d)
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// A warpgroup's accumulators: ENF_NBW n-blocks of 64 x 64. Thread t of the
// warpgroup holds, of n-block j, rows 16 (t / 32) + (t % 32) / 4 (+ 8) and
// columns 8 i + 2 (t % 4) (+ 1), i < 8: v[j][4 i + 2 h + e] is row + 8 h,
// column + e.
struct WAcc {
  float v[ENF_NBW][32];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < ENF_NBW; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) v[j][i] = 0.f;
  }
  // Keeps the compiler from moving reads or writes of the accumulators
  // across the asynchronous products.
  __device__ __forceinline__ void fence() {
#pragma unroll
    for (int j = 0; j < ENF_NBW; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(v[j][i])::"memory");
  }
};

__host__ __device__ __forceinline__ int nb64(int n) { return (n + 63) >> 6; }

// The weight ring: n slots of `bytes` from shared address `base`, each with
// a full barrier (the producer's arrival and the stage's bytes) and an
// empty one (one arrival per consumer warp).
struct Ring {
  u64* full;
  u64* empty;
  unsigned base;
  int n, bytes;
};

struct Pipe {
  int slot;
  unsigned phase;
  __device__ __forceinline__ void next(int n) {
    if (++slot == n) {
      slot = 0;
      phase ^= 1u;
    }
  }
};

// The ring at the start of dynamic shared memory; thread 0 initializes its
// barriers (the caller synchronizes the block).
__device__ __forceinline__ Ring ring_at(unsigned char* smem, int n,
                                        int bytes) {
  u64* bars = reinterpret_cast<u64*>(smem);
  const Ring rg{bars, bars + ENF_MAX_RING, saddr(smem + ENF_BARS), n, bytes};
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) {
      mbar_init(&rg.full[i], 1);
      mbar_init(&rg.empty[i], ENF_CONS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  return rg;
}

// A slot takes as many k-steps of a pass as fit (one of the widest pass,
// several of a narrow one such as a spline slab), so that a narrow pass
// keeps as many bytes in flight as a wide one.
__device__ __forceinline__ int ksteps_a_slot(int slot_bytes, int bytes) {
  return slot_bytes / bytes;
}

struct Producer {
  Ring rg;
  Pipe p;
  // `ksteps` k-steps of `bytes` each, contiguous from `src`.
  __device__ void load(const float* src, int ksteps, int bytes) {
    const int per = ksteps_a_slot(rg.bytes, bytes);
    for (int kk = 0; kk < ksteps; kk += per) {
      const int b = min(per, ksteps - kk) * bytes;
      mbar_wait(&rg.empty[p.slot], p.phase ^ 1u);
      mbar_expect_tx(&rg.full[p.slot], b);
      bulk_g2s(rg.base + p.slot * rg.bytes, src + (size_t)kk * (bytes >> 2),
               b, &rg.full[p.slot]);
      p.next(rg.n);
    }
  }
};

// acc += A times the next `ksteps` k-steps from the ring (ksteps_a_slot of
// them a slot). A: 64 rows in shared memory at a_addr, K-major, 8-row
// groups a_sbo bytes apart, k-step kk at a_addr + 256 kk. A k-step of the
// pass: `bytes` / 2048 n-blocks of 64 columns, 8-column groups 256 bytes
// apart. Warpgroup w takes n-blocks w, w + 2, ... into
// acc.v[0], acc.v[1], ..., NW of them: with an odd count of n-blocks the
// second warpgroup's last one reads past the stage, and its columns are
// never read. The issue is free of branches, so that the products of a
// k-step go to the tensor cores back to back. A slot is released as soon
// as its last k-step has retired: the weights arrive from L2 slower than
// the tensor cores use them, so the producer gets every slot back at once
// rather than keeping a k-step queued on the tensor cores. The caller
// synchronizes the consumers before overwriting A.
template <int NW, bool BF>
__device__ void prod_loop(WAcc& acc, const Ring& rg, Pipe& pp,
                          unsigned a_addr, unsigned a_sbo, int ksteps,
                          int bytes) {
  const unsigned boff = (threadIdx.x >> 7) * 2048;
  const bool lead = (threadIdx.x & 31) == 0;
  const int per = ksteps_a_slot(rg.bytes, bytes);
  for (int kk = 0, in = 0; kk < ksteps; ++kk) {
    if (in == 0) mbar_wait(&rg.full[pp.slot], pp.phase);
    const unsigned b = rg.base + pp.slot * rg.bytes + in * bytes + boff;
    const u64 da = gdesc(a_addr + kk * 256, 128, a_sbo);
    acc.fence();
    wg_fence();
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      if constexpr (BF)
        wgmma_bf16(acc.v[j], da, gdesc(b + j * 4096, 128, 256));
      else
        wgmma_tf32(acc.v[j], da, gdesc(b + j * 4096, 128, 256));
    }
    wg_commit();
    wg_wait<0>();
    acc.fence();
    if (++in == per || kk + 1 == ksteps) {
      if (lead) mbar_arrive(&rg.empty[pp.slot]);
      pp.next(rg.n);
      in = 0;
    }
  }
}

// prod_loop for a pass of nb n-blocks on the layer's operands.
__device__ void wg_product(WAcc& acc, const Ring& rg, Pipe& pp,
                           unsigned a_addr, unsigned a_sbo, int ksteps,
                           int nb, bool bf) {
  const int nw = (nb + 1) >> 1, bytes = nb * 2048;
  if (bf) {
    if (nw == 1)
      prod_loop<1, true>(acc, rg, pp, a_addr, a_sbo, ksteps, bytes);
    else if (nw == 2)
      prod_loop<2, true>(acc, rg, pp, a_addr, a_sbo, ksteps, bytes);
    else if (nw == 3)
      prod_loop<3, true>(acc, rg, pp, a_addr, a_sbo, ksteps, bytes);
    else
      prod_loop<4, true>(acc, rg, pp, a_addr, a_sbo, ksteps, bytes);
  } else {
    if (nw == 1)
      prod_loop<1, false>(acc, rg, pp, a_addr, a_sbo, ksteps, bytes);
    else if (nw == 2)
      prod_loop<2, false>(acc, rg, pp, a_addr, a_sbo, ksteps, bytes);
    else if (nw == 3)
      prod_loop<3, false>(acc, rg, pp, a_addr, a_sbo, ksteps, bytes);
    else
      prod_loop<4, false>(acc, rg, pp, a_addr, a_sbo, ksteps, bytes);
  }
}

// The thread's index, read anew where it is used: the 128 addresses
// for_acc derives from it would otherwise be hoisted out of the tile loops
// and spilled to local memory, to be reloaded at every epilogue.
__device__ __forceinline__ int tid_here() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

// f(r, c, v) for every accumulator of this warpgroup's n-blocks (as
// wg_product assigns them) in the first ncols (a multiple of 8) columns.
template <class F>
__device__ __forceinline__ void for_acc(WAcc& acc, int ncols, F f) {
  const int t = tid_here();
  const int wg = t >> 7, w = (t >> 5) & 3;
  const int g = (t & 31) >> 2, q = t & 3;
  const int r = 16 * w + g;
#pragma unroll
  for (int j = 0; j < ENF_NBW; ++j) {
    const int cb = (2 * j + wg) * 64;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = cb + 8 * i + 2 * q;
      if (c < ncols) {
        f(r, c, acc.v[j][4 * i]);
        f(r, c + 1, acc.v[j][4 * i + 1]);
        f(r + 8, c, acc.v[j][4 * i + 2]);
        f(r + 8, c + 1, acc.v[j][4 * i + 3]);
      }
    }
  }
}

// The activation buffer H as a product's A: element (r, k) of the K-major
// layout with 8-row groups `lda` values of K apart; f32 (TF32 values) for
// a TF32 coupling, bf16 for a bf16 one (its stride byte offset 32 lda or
// 16 lda bytes).
__device__ __forceinline__ int hidx(int r, int k, int lda, bool bf) {
  return bf ? (r >> 3) * 8 * lda + (k >> 3) * 64 + (r & 7) * 8 + (k & 7)
            : (r >> 3) * 8 * lda + (k >> 2) * 32 + (r & 7) * 4 + (k & 3);
}

__device__ __forceinline__ void hset(unsigned char* H, int i, float v,
                                     bool bf) {
  if (bf)
    reinterpret_cast<__nv_bfloat16*>(H)[i] = __float2bfloat16_rn(v);
  else
    reinterpret_cast<float*>(H)[i] = v;
}

// The e-th element of a 64 x K fill of H in the layout's own order, so
// that neighbouring threads write neighbouring banks (K a multiple of 8).
__device__ __forceinline__ void fill_rc(int e, int K, bool bf, int& r,
                                        int& k) {
  const int cw = bf ? 8 : 4, cs = bf ? 3 : 2;  // values of K a core row
  const int kc = e & (cw - 1), r8 = (e >> cs) & 7, rest = e >> (cs + 3);
  const int ncore = K >> cs;
  r = (rest / ncore) * 8 + r8;
  k = (rest % ncore) * cw + kc;
}

// Row stride of the f32 staging area of a bf16 coupling's epilogues: one
// warpgroup's n-blocks of a pass as wide as lda allows, plus 4.
__host__ __device__ __forceinline__ int st_ld(int lda) {
  return 64 * ((nb64(lda) + 1) / 2) + 4;
}

// Bytes of HR, the activation buffer: H (64 x lda values, f32) or, for a
// bf16 coupling, H in bf16 and the f32 staging area behind it.
__host__ __device__ __forceinline__ long long hr_bytes(int lda, bool bf) {
  const long long f = 4LL * ENF_TM * lda;
  const long long b = 2LL * ENF_TM * lda + 4LL * ENF_TM * st_ld(lda);
  return bf && b > f ? b : f;
}

// HR's bytes for a plan: with the staging area when a layer is bf16.
__host__ __device__ __forceinline__ long long plan_hr(const CPlan& p,
                                                     int lda) {
  bool bf = false;
  for (int l = 0; l < p.n_layers; ++l) bf = bf || p.layer[l][7] != 0;
  return hr_bytes(lda, bf);
}

// B5's HR bytes: H, or in the sweep a slab in rows of ldo and its rounded
// cotangent beside it (64 x the widest slab depth, 4 bytes a value).
__host__ __device__ __forceinline__ long long plan_hr_bwd(const CPlan& p,
                                                         int lda, int ldo) {
  int sk = 0;
  for (int i = 0; i < p.n_items; ++i)
    if (p.item[i][0] != K_ELEM) {
      const int sw = p.item[i][10];
      const int d = p.layer[p.item[i][5]][7] ? (sw + 15) / 16 * 16 : sw;
      sk = d > sk ? d : sk;
    }
  const long long h = plan_hr(p, lda), o = 4LL * ENF_TM * (ldo + sk);
  return h > o ? h : o;
}

// The epilogue of a product whose output goes back into H, as its next A.
// The accumulators are staged in shared memory first: a TF32 coupling's
// in H itself (f32), a bf16 one's, a warpgroup at a time, in the f32 area
// behind its bf16 H. Then each thread takes one column c and 8 rows r[i]
// at a time and f(c, r, v) turns their 8 staged values v into what H
// holds there, in a rolled loop (so that f's code is there once) whose
// every step can issue all its loads (a bias, 8 pre-activations) before it
// computes. Starts with every warpgroup's product retired and the
// consumers synchronized; ends with H written and fenced for wgmma, the
// consumers synchronized.
template <class F>
__device__ void epi_to_h(WAcc& acc, int ncols, unsigned char* HR, int lda,
                         bool bf, F f) {
  int r[8];
  float v[8];
  if (!bf) {
    float* H = reinterpret_cast<float*>(HR);
    for_acc(acc, ncols, [&](int rr, int c, float x) {
      H[hidx(rr, c, lda, false)] = x;
    });
    csync();
    // Warp w takes core matrices w, w + 8, ... along K, a lane the same
    // element of each of the 8 row groups: a warp reads and writes 128
    // contiguous bytes at a time.
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < 8; ++i) r[i] = i * 8 + (lane >> 2);
    for (int core = warp; core < (ncols >> 2); core += ENF_CONS / 32) {
      float* h = H + core * 32 + lane;
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = h[i * 8 * lda];
      f(core * 4 + (lane & 3), r, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) h[i * 8 * lda] = v[i];
    }
  } else {
    float* ST = reinterpret_cast<float*>(HR + 2LL * ENF_TM * lda);
    const int ld = st_ld(lda), nb = nb64(ncols);
    for (int half = 0; half < 2; ++half) {
      if ((int)(threadIdx.x >> 7) == half)
        for_acc(acc, ncols, [&](int rr, int c, float x) {
          ST[rr * ld + ((c >> 7) << 6) + (c & 63)] = x;
        });
      csync();
      // A thread takes one column and rows q, q + 4, ... (q = tid / 64),
      // 8 of them at a time.
      const int w = 64 * ((nb - half + 1) >> 1);  // this half's columns
      for (int cc = threadIdx.x & 63; cc < w; cc += 64) {
        const int c = (((cc >> 6) << 1) + half) * 64 + (cc & 63);
        if (c >= ncols) continue;
        for (int r0 = threadIdx.x >> 6; r0 < ENF_TM; r0 += 32) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            r[i] = r0 + 4 * i;
            v[i] = ST[r[i] * ld + cc];
          }
          f(c, r, v);
#pragma unroll
          for (int i = 0; i < 8; ++i) hset(HR, hidx(r[i], c, lda, true), v[i], true);
        }
      }
      csync();
    }
  }
  fence_proxy_async();
  csync();
}

// B5's scratch: per layer its inputs h_in (rows x Kp) and pre-activations,
// then their cotangents, g_pre (rows x Np), each an array of `rows` (a
// multiple of 64) rows at a column base, in the K-major layout coupling_dw
// reads with the batch as K: per 32 rows, per 8 columns, 8 core matrices
// of 8 columns x 4 rows. (R, k) of a W-wide array is at sidx(R, k, W).
__device__ __forceinline__ long long sidx(long long R, int k, int W) {
  return (((R >> 5) * (W >> 3) + (k >> 3)) << 8) + (((R & 31) >> 2) << 5) +
         ((k & 7) << 2) + (R & 3);
}

struct Scr {
  float* base;        // null: B4 without B5's rows
  long long rows, r0;  // the arrays' rows; the tile's first row
  __device__ __forceinline__ float* arr(int cb) const {
    return base + rows * cb;
  }
};

// The weight stages of one coupling's forward, in the consumers' order:
// each hidden layer's W over its whole width, then the last layer's W slab
// by slab (the wrapper packs W pass by pass, k-step by k-step, each
// k-step's block 2048 bytes per n-block).
__device__ void fwd_stages(const CPlan& plan, const int* it,
                           const float* Wk, Producer& pr) {
  const int nl = it[4], l0 = it[5], KS = plan.layer[l0][7] ? 16 : 8;
  for (int l = 0; l + 1 < nl; ++l) {
    const int* L = plan.layer[l0 + l];
    pr.load(Wk + L[2], L[0] / KS, nb64(L[1]) * 2048);
  }
  const int* L = plan.layer[l0 + nl - 1];
  const int ks = L[0] / KS, bytes = nb64(it[10]) * 2048;
  for (int s = 0; s < it[11]; ++s)
    pr.load(Wk + L[2] + (size_t)s * ks * (bytes >> 2), ks, bytes);
}

// The weight stages of one coupling's reverse sweep: the last layer's W^T
// slab by slab (a bf16 slab at its depth padded to 16), then each lower
// layer's W^T.
__device__ void bwd_stages(const CPlan& plan, const int* it,
                           const float* Wk, Producer& pr) {
  const int nl = it[4], l0 = it[5];
  const bool bf = plan.layer[l0][7] != 0;
  const int KS = bf ? 16 : 8;
  const int* LL = plan.layer[l0 + nl - 1];
  const int SK = bf ? (it[10] + 15) / 16 * 16 : it[10];
  const int ks = SK / KS, bytes = nb64(LL[0]) * 2048;
  for (int s = 0; s < it[11]; ++s)
    pr.load(Wk + LL[3] + (size_t)s * ks * (bytes >> 2), ks, bytes);
  for (int l = nl - 1; l >= 1; --l) {
    const int* Lp = plan.layer[l0 + l - 1];
    pr.load(Wk + Lp[3], Lp[1] / KS, nb64(Lp[0]) * 2048);
  }
}

// One elementwise stage's forward on the tile S, four threads a row, its
// ladj terms summed per row in a fixed order into Lr (when given).
__device__ __forceinline__ void elem_rows(int code, int slot, float* S,
                                          float* Lr, const float* P, int d) {
  const int r = threadIdx.x >> 2, q = threadIdx.x & 3;  // 4 ENF_TM threads
  float sum = 0.f;
  for (int k = q; k < d; k += 4) {
    float el;
    S[r * d + k] = stage_fwd(code, S[r * d + k], P, slot, d, k, &el);
    sum += el;
  }
  sum += __shfl_down_sync(0xffffffffu, sum, 2);
  sum += __shfl_down_sync(0xffffffffu, sum, 1);
  if (Lr && q == 0) Lr[r] += sum;
}

// One coupling on the tile, shared by B4 and B5's recompute: the
// conditioner from the src half of S through H, then the last layer slab
// by slab into O (row stride ldo) with each slab's epilogue on the target
// half of S, its ladj terms summed per row into Lr (when given). With
// scratch rows, every layer's input and pre-activation go to the scratch.
// `epi` false skips the epilogue (B5's last stage). Starts and ends with
// the consumers synchronized.
__device__ void coupling_tile(const CPlan& plan, const int* it,
                              const float* itf, float* S, float* Lr, int d,
                              unsigned char* HR, int lda, float* O, int ldo,
                              const Ring& rg, Pipe& pipe,
                              const float* __restrict__ Wk, const Scr& scr,
                              bool epi, float shift) {
  const int da = d / 2, src = it[1], act = it[3], nl = it[4], l0 = it[5];
  const bool save = scr.base != nullptr;
  const bool bf = plan.layer[l0][7] != 0;  // the coupling's products
  const int KS = bf ? 16 : 8;
  const unsigned ha = saddr(HR), sbo = (bf ? 16u : 32u) * lda;
  const long long r0 = scr.r0;
  WAcc acc;
  {
    const int Kp = plan.layer[l0][0];
    float* hin = save ? scr.arr(plan.layer[l0][5]) : nullptr;
    for (int e = threadIdx.x; e < ENF_TM * Kp; e += ENF_CONS) {
      int r, k;
      fill_rc(e, Kp, bf, r, k);
      const float v = k < da ? oprnd(S[r * d + src * da + k], bf) : 0.f;
      hset(HR, hidx(r, k, lda, bf), v, bf);
      if (save) hin[sidx(r0 + r, k, Kp)] = v;
    }
  }
  fence_proxy_async();
  csync();
  for (int l = 0; l + 1 < nl; ++l) {  // hidden layers, in place in H
    const int* L = plan.layer[l0 + l];
    const int Kp = L[0], Np = L[1];
    const float* b = Wk + L[4];
    acc.zero();
    wg_product(acc, rg, pipe, ha, sbo, Kp / KS, nb64(Np), bf);
    csync();  // both warpgroups have read H
    // Bias and activation; B5's rows (the pre-activation and the activated
    // value) to the scratch.
    float* pre = save ? scr.arr(L[5] + Kp) : nullptr;
    float* post = save ? scr.arr(plan.layer[l0 + l + 1][5]) : nullptr;
    epi_to_h(acc, Np, HR, lda, bf, [&](int c, const int* r, float* v) {
      const float bc = __ldg(b + c);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = v[i] + bc;
        v[i] = oprnd(act_fwd(act, p), bf);
        if (save) {
          const long long q = sidx(r0 + r[i], c, Np);
          pre[q] = p;
          post[q] = v[i];
        }
      }
    });
  }
  const int* L = plan.layer[l0 + nl - 1];
  const int Kp = L[0], Np = L[1], G = it[9], SW = it[10], nslab = it[11];
  const int tgt = 1 - src, K = it[8];
  const bool inv = it[2] != 0, spline = it[0] == K_SPLINE;
  const float* b = Wk + L[4];
  float* pre = save ? scr.arr(L[5] + Kp) : nullptr;
  for (int s = 0; s < nslab; ++s) {
    acc.zero();
    wg_product(acc, rg, pipe, ha, sbo, Kp / KS, nb64(SW), bf);
    csync();  // O is free: the last slab's row sums are read
    for_acc(acc, SW, [&](int r, int c, float v) {
      const float p = v + __ldg(b + s * SW + c);
      O[r * ldo + c] = p;
      if (save) pre[sidx(r0 + r, s * SW + c, Np)] = p;
    });
    csync();
    if (!epi) continue;
    const int j0 = s * G, gs = min(G, da - j0);
    for (int e = threadIdx.x; e < ENF_TM * gs; e += ENF_CONS) {
      const int r = e / gs, jj = e - r * gs;
      const int idx = r * d + tgt * da + j0 + jj;
      float* h = O + r * ldo;
      float el;
      S[idx] = spline ? spline_fwd(S[idx], h, G, jj, K, itf[1], inv, shift,
                                   &el)
                      : affine_fwd(S[idx], h, G, jj, itf[0], inv, &el);
      h[jj] = el;  // after this lane's last read of its columns p G + jj
    }
    csync();
    if (Lr)
      for (int r = threadIdx.x; r < ENF_TM; r += ENF_CONS) {
        float sum = 0.f;
        for (int jj = 0; jj < gs; ++jj) sum += O[r * ldo + jj];
        Lr[r] += sum;
      }
  }
  csync();
}

// B4: replaces _fused_coupling_impl (ops/pallas/coupling.py:677-716).
// Shared memory: the ring's barriers (ENF_BARS bytes), the ring (nring x
// slot_bytes), HR (H, plan_hr bytes), S (64 x d) the state, O (64 x ldo)
// a slab of the last layer, Lr (64) the ladj sums. Persistent
// grid-stride loop over tiles of 64 rows. x, y and ladj in bf16 where
// `bfio`, else f32. With `scratch` and `svs` (arrays of `rows` rows, a
// multiple of 64), B5's rows for every row of every tile.
__global__ void __launch_bounds__(ENF_THREADS, 1)
    coupling_fwd_kernel(const void* __restrict__ x, void* __restrict__ y,
                        void* __restrict__ ladj,
                        const float* __restrict__ Wk,
                        const float* __restrict__ P,
                        const __grid_constant__ CPlan plan, long long n,
                        long long rows, int d, int lda, int ldo, int nring,
                        int slot_bytes, float* scratch, float* svs,
                        float shift, int bfio) {
  extern __shared__ __align__(128) unsigned char wsmem[];
  unsigned char* smem = wsmem;
  const Ring rg = ring_at(smem, nring, slot_bytes);
  unsigned char* HR = smem + ENF_BARS + (size_t)nring * slot_bytes;
  float* S = reinterpret_cast<float*>(HR + plan_hr(plan, lda));
  float* O = S + ENF_TM * d;
  float* Lr = O + ENF_TM * ldo;
  const int da = d / 2;
  const long long ntiles = (n + ENF_TM - 1) / ENF_TM;
  __syncthreads();
  if (threadIdx.x >= ENF_CONS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == ENF_CONS) {
      Producer pr{rg, {0, 0u}};
      for (long long ti = blockIdx.x; ti < ntiles; ti += gridDim.x)
        for (int i = 0; i < plan.n_items; ++i)
          if (plan.item[i][0] != K_ELEM) fwd_stages(plan, plan.item[i], Wk, pr);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  Pipe pipe{0, 0u};
  for (long long ti = blockIdx.x; ti < ntiles; ti += gridDim.x) {
    const long long r0 = ti * ENF_TM;
    const int ns = (int)min((long long)ENF_TM, n - r0);
    const Scr scr{scratch, rows, r0};
    for (int e = threadIdx.x; e < ENF_TM * d; e += ENF_CONS)
      S[e] = e < ns * d ? ld_io(x, r0 * d + e, bfio) : 0.f;
    for (int r = threadIdx.x; r < ENF_TM; r += ENF_CONS) Lr[r] = 0.f;
    csync();
    for (int i = 0, coff = 0; i < plan.n_items; ++i) {
      const int* it = plan.item[i];
      if (svs) {  // the stage's input as B5's sweep reads it
        const int w = it[0] == K_ELEM ? d : da;
        const int c0 = it[0] == K_ELEM ? 0 : (1 - it[1]) * da;
        float* dst = svs + rows * coff + r0 * w;
        for (int e = threadIdx.x; e < ENF_TM * w; e += ENF_CONS) {
          const int r = e / w;
          dst[e] = S[r * d + c0 + e - r * w];
        }
        coff += w;
        csync();
      }
      if (it[0] == K_ELEM) {
        elem_rows(it[6], it[7], S, Lr, P, d);
        csync();
      } else {
        coupling_tile(plan, it, plan.itemf[i], S, Lr, d, HR, lda, O, ldo, rg,
                      pipe, Wk, scr, true, shift);
      }
    }
    for (int e = threadIdx.x; e < ns * d; e += ENF_CONS)
      st_io(y, r0 * d + e, S[e], bfio);
    for (int r = threadIdx.x; r < ns; r += ENF_CONS)
      st_io(ladj, r0 + r, Lr[r], bfio);
    csync();
  }
}

// Columns [c0, c0 + w) (w a multiple of 8) of the 64 scratch rows from r0
// of a W-wide array a, to (`in`) or from O (rows of ldo), a warp moving 32
// consecutive floats of the scratch layout at a time (4 rows x 8 columns,
// conflict-free in O when ldo is a multiple of 8), each thread 8 of them
// in flight.
__device__ __forceinline__ void slab_copy(float* O, int ldo, float* a,
                                          long long r0, int c0, int w, int W,
                                          bool in) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ng = w >> 3, units = 2 * ng * 8;  // 32-row halves x groups x cores
  const int rr = lane & 3, cc = lane >> 2;
  for (int u0 = warp; u0 < units; u0 += 8 * (ENF_CONS / 32)) {
    float v[8];
    long long gpos[8];
    int opos[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int u = min(u0 + i * (ENF_CONS / 32), units - 1);
      const int h = u / (8 * ng), rem = u - h * 8 * ng, gi = rem >> 3,
                q = rem & 7;
      gpos[i] = ((((r0 >> 5) + h) * (W >> 3) + ((c0 >> 3) + gi)) << 8) +
                (q << 5) + lane;
      opos[i] = (h * 32 + q * 4 + rr) * ldo + gi * 8 + cc;
      if (in) v[i] = __ldcg(a + gpos[i]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (u0 + i * (ENF_CONS / 32) < units) {
        if (in)
          O[opos[i]] = v[i];
        else
          a[gpos[i]] = O[opos[i]];
      }
  }
}

// B5 (a): replaces the recompute + in-tile vjp of _fused_coupling_bwd_impl
// (ops/pallas/coupling.py:616-674). For the n rows of one chunk: gx from
// gy (physical lane order) and gl; every conditioner layer's input h_in and
// pre-activation cotangent g_pre into the scratch; per block sums of the
// elementwise-parameter cotangents into p_part (grid, n_pslots * d). The
// stage inputs the reverse sweep reads are in svs (rows x d for an
// elementwise stage, rows x d/2 for a coupling's target half, stage after
// stage): B4's, or with `recompute` written here by a forward recompute of
// each tile. Shared memory: the ring's barriers and the ring, HR (64 x
// HR (H as the products' A, or in the sweep a slab of the last layer in
// rows of ldo and its rounded cotangent; plan_hr_bwd), SC (64 x d) the state during the
// recompute and then the running cotangent, GL (64) the ladj cotangents,
// PACC (n_pslots x d) and, with `recompute`, the recompute's slab buffer
// (64 x ldo; its last layer reads H while a slab is written). x, gy, gl
// and gx in bf16 where `bfio`, else f32.
__global__ void __launch_bounds__(ENF_THREADS, 1)
    coupling_bwd_kernel(const void* __restrict__ x,
                        const void* __restrict__ gy,
                        const void* __restrict__ gl,
                        void* __restrict__ gx, const float* __restrict__ Wk,
                        const float* __restrict__ P,
                        const __grid_constant__ CPlan plan, long long n,
                        long long rows, int d, int lda, int ldo, int nring,
                        int slot_bytes, int n_pslots, float* scratch,
                        float* svs, int recompute, float* __restrict__ p_part,
                        float shift, int bfio) {
  extern __shared__ __align__(128) unsigned char wsmem[];
  unsigned char* smem = wsmem;
  const Ring rg = ring_at(smem, nring, slot_bytes);
  unsigned char* HR = smem + ENF_BARS + (size_t)nring * slot_bytes;
  float* SC = reinterpret_cast<float*>(HR + plan_hr_bwd(plan, lda, ldo));
  float* GL = SC + ENF_TM * d;
  float* PACC = GL + ENF_TM;
  float* OR = PACC + n_pslots * d;
  const int da = d / 2, ni = plan.n_items;
  int sv_row = 0;
  for (int i = 0; i < ni; ++i) sv_row += plan.item[i][0] == K_ELEM ? d : da;
  const long long ntiles = (n + ENF_TM - 1) / ENF_TM;
  __syncthreads();
  if (threadIdx.x >= ENF_CONS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == ENF_CONS) {
      Producer pr{rg, {0, 0u}};
      for (long long ti = blockIdx.x; ti < ntiles; ti += gridDim.x) {
        for (int i = 0; recompute && i < ni; ++i)
          if (plan.item[i][0] != K_ELEM) fwd_stages(plan, plan.item[i], Wk, pr);
        for (int i = ni - 1; i >= 0; --i)
          if (plan.item[i][0] != K_ELEM) bwd_stages(plan, plan.item[i], Wk, pr);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  for (int q = threadIdx.x; q < n_pslots * d; q += ENF_CONS) PACC[q] = 0.f;
  Pipe pipe{0, 0u};
  for (long long ti = blockIdx.x; ti < ntiles; ti += gridDim.x) {
    const long long r0 = ti * ENF_TM;
    const int ns = (int)min((long long)ENF_TM, n - r0);
    const Scr scr{scratch, rows, r0};
    for (int e = threadIdx.x; e < ENF_TM * d; e += ENF_CONS)
      SC[e] = e < ns * d ? ld_io(x, r0 * d + e, bfio) : 0.f;
    for (int r = threadIdx.x; r < ENF_TM; r += ENF_CONS)
      GL[r] = r < ns ? ld_io(gl, r0 + r, bfio) : 0.f;
    csync();

    // The forward, when B4 did not store its rows: each stage's input to
    // svs, the conditioners' rows to the scratch.
    for (int i = 0, coff = 0; recompute && i < ni; ++i) {
      const int* it = plan.item[i];
      const int w = it[0] == K_ELEM ? d : da;
      const int c0 = it[0] == K_ELEM ? 0 : (1 - it[1]) * da;
      float* dst = svs + rows * coff + r0 * w;
      for (int e = threadIdx.x; e < ENF_TM * w; e += ENF_CONS) {
        const int r = e / w;
        dst[e] = SC[r * d + c0 + e - r * w];
      }
      coff += w;
      csync();
      if (it[0] == K_ELEM) {
        elem_rows(it[6], it[7], SC, nullptr, P, d);
        csync();
      } else {
        coupling_tile(plan, it, plan.itemf[i], SC, nullptr, d, HR, lda, OR,
                      ldo, rg, pipe, Wk, scr, i + 1 < ni, shift);
      }
    }

    float* CY = SC;
    for (int e = threadIdx.x; e < ENF_TM * d; e += ENF_CONS)
      CY[e] = e < ns * d ? ld_io(gy, r0 * d + e, bfio) : 0.f;
    csync();

    // Reverse sweep of the hand-derived adjoints.
    for (int i = ni - 1, coff = sv_row; i >= 0; --i) {
      const int* it = plan.item[i];
      const int w = it[0] == K_ELEM ? d : da;
      coff -= w;
      const float* cur = svs + rows * coff + r0 * w;
      if (it[0] == K_ELEM) {
        // One thread per lane, rows in order: each PACC entry has one owner.
        const int code = it[6], slot = it[7], np = n_params(code);
        for (int k = threadIdx.x; k < d; k += ENF_CONS) {
          float a4[4] = {0.f, 0.f, 0.f, 0.f};
          for (int rb = 0; rb < ns; rb += 8) {
            float t[8];  // 8 rows' inputs in flight
#pragma unroll
            for (int u = 0; u < 8; ++u)
              t[u] = rb + u < ns ? cur[(rb + u) * d + k] : 0.f;
            for (int u = 0; u < 8 && rb + u < ns; ++u) {
              const int r = rb + u;
              float g[4];
              CY[r * d + k] = stage_bwd(code, t[u], P, slot, d, k,
                                        CY[r * d + k], GL[r], g);
              for (int q = 0; q < np; ++q) a4[q] += g[q];
            }
          }
          for (int q = 0; q < np; ++q) PACC[(slot + q) * d + k] += a4[q];
        }
        csync();
        continue;
      }
      const int src = it[1], tgt = 1 - src, act = it[3], nl = it[4],
                l0 = it[5], K = it[8], G = it[9], SW = it[10],
                nslab = it[11];
      const bool inv = it[2] != 0, spline = it[0] == K_SPLINE;
      const bool bf = plan.layer[l0][7] != 0;  // the coupling's products
      const int KS = bf ? 16 : 8;
      const unsigned ha = saddr(HR), sbo = (bf ? 16u : 32u) * lda;
      const int* LL = plan.layer[l0 + nl - 1];
      const int KpL = LL[0], NpL = LL[1];
      float* gL = scr.arr(LL[5] + KpL);
      // Each slab: the conditioner output from the scratch into O (rows of
      // ldo), the adjoint in place, its cotangent back to the scratch in
      // f32 (db sums it).
      float* O = reinterpret_cast<float*>(HR);
      for (int s = 0; s < nslab; ++s) {
        slab_copy(O, ldo, gL, r0, s * SW, SW, NpL, true);
        csync();
        const int j0 = s * G, gs = min(G, da - j0);
        for (int e = threadIdx.x; e < ENF_TM * gs; e += ENF_CONS) {
          const int r = e / gs, jj = e - r * gs;
          const int idx = r * d + tgt * da + j0 + jj;
          float* h = O + r * ldo;
          const float xv = cur[r * da + j0 + jj];
          CY[idx] = spline ? spline_bwd(xv, h, G, jj, K, plan.itemf[i][1],
                                        inv, shift, CY[idx], GL[r], h)
                           : affine_bwd(xv, h, G, jj, plan.itemf[i][0], inv,
                                        CY[idx], GL[r], h);
        }
        csync();
        slab_copy(O, ldo, gL, r0, s * SW, SW, NpL, false);
        csync();
      }
      // dh = g_pre W^T of the last layer, accumulated over the slabs: each
      // slab's cotangent from the scratch, rounded, into HA, the product's
      // A, K-major with 8-row groups SK values apart, beside O; a bf16
      // slab read at a depth SK padded to 16 with zero columns, against
      // W^T packed slab by slab at that depth.
      const int SK = bf ? (SW + 15) / 16 * 16 : SW;
      unsigned char* HA = HR + 4 * ENF_TM * ldo;
      WAcc acc;
      acc.zero();
      for (int s = 0; s < nslab; ++s) {
        slab_copy(O, ldo, gL, r0, s * SW, SW, NpL, true);
        csync();
        for (int e = threadIdx.x; e < ENF_TM * SK; e += ENF_CONS) {
          int r, c;
          fill_rc(e, SK, bf, r, c);
          hset(HA, hidx(r, c, SK, bf), c < SW ? oprnd(O[r * ldo + c], bf) : 0.f,
               bf);
        }
        fence_proxy_async();
        csync();
        wg_product(acc, rg, pipe, saddr(HA), (bf ? 16u : 32u) * SK, SK / KS,
                   nb64(KpL), bf);
        csync();  // both warpgroups have read HA; O is free
      }
      // Down the layers: acc holds the cotangent of layer l's input.
      for (int l = nl - 1;; --l) {
        const int Kp = plan.layer[l0 + l][0];
        if (l == 0) {
          for_acc(acc, Kp, [&](int r, int c, float v) {
            if (c < da) CY[r * d + src * da + c] += v;
          });
          csync();
          break;
        }
        // The activation's adjoint on the accumulators against the stored
        // pre-activation; g_pre over it in the scratch in f32, rounded into
        // H for the product.
        const int* Lp = plan.layer[l0 + l - 1];  // its Np is Kp
        float* gp = scr.arr(Lp[5] + Lp[0]);
        epi_to_h(acc, Kp, HR, lda, bf, [&](int c, const int* r, float* v) {
          long long q[8];
          float pv[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            q[i] = sidx(r0 + r[i], c, Kp);
            pv[i] = __ldcg(gp + q[i]);
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float g = act_bwd(act, pv[i], v[i]);
            gp[q[i]] = g;
            v[i] = oprnd(g, bf);
          }
        });
        acc.zero();
        wg_product(acc, rg, pipe, ha, sbo, Kp / KS, nb64(Lp[0]), bf);
        csync();
      }
    }

    for (int e = threadIdx.x; e < ns * d; e += ENF_CONS)
      st_io(gx, r0 * d + e, CY[e], bfio);
    csync();
  }
  for (int q = threadIdx.x; q < n_pslots * d; q += ENF_CONS)
    p_part[(size_t)blockIdx.x * n_pslots * d + q] = PACC[q];
}

// coupling_dw_kernel's stages: warpgroup w's 64 dW rows times NB n-blocks
// of 64 columns, 4 k-steps of 8 batch rows a stage, issued without
// branches (a warpgroup whose rows lie past the layer computes on what the
// stage holds there, and its rows are never stored). prep(slot) readies a
// stage's g_pre; the next stage is readied while the tensor cores run this.
template <int NB, class F>
__device__ void dw_loop(WAcc& acc, const Ring& rg, int nst, F prep) {
  const unsigned aoff = (threadIdx.x >> 7) * 8192;
  const bool lead = (threadIdx.x & 31) == 0;
  Pipe p{0, 0u};
  if (nst > 0) {
    mbar_wait(&rg.full[0], 0u);
    prep(0);
    fence_proxy_async();
    csync();
  }
  for (int st = 0; st < nst; ++st) {
    const unsigned a = rg.base + p.slot * ENF_DW_STAGE;
    const unsigned b = a + 4 * ENF_DWR * ENF_DWM;
    acc.fence();
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < ENF_DWR / 8; ++ks) {
      const u64 da = gdesc(a + aoff + ks * 256, 128, 1024);
#pragma unroll
      for (int j = 0; j < NB; ++j)
        wgmma_tf32(acc.v[j], da, gdesc(b + j * 8192 + ks * 256, 128, 1024));
    }
    wg_commit();
    const int cur = p.slot;
    p.next(rg.n);
    if (st + 1 < nst) {
      mbar_wait(&rg.full[p.slot], p.phase);
      prep(p.slot);
      fence_proxy_async();
    }
    wg_wait<0>();
    acc.fence();
    if (lead) mbar_arrive(&rg.empty[cur]);
    csync();
  }
}

// B5 (b): dW = sum_r h_in[r]^T g_pre[r] and db = sum_r g_pre[r] for every
// layer over the `rows` scratch rows of one chunk (a multiple of 64),
// split into nsplit fixed ranges of 32-row chunks. A block owns one split
// of a 128 x 256 tile of a layer's (Kp, Np) dW: warpgroup w its rows
// 64 w .. 64 w + 63, all its columns, on wgmma m64n64k8 TF32 with the batch
// as K. The scratch's layout makes a stage, 32 rows of the tile's h_in
// and g_pre columns, two contiguous runs: the producer copies each with
// one cp.async.bulk into a ring of 4 stages. h_in is rounded already; the
// consumers sum each g_pre column in f32 in row order for db (the blocks
// of the first row of tiles) and round it in place, as the product reads
// it: TF32, or bf16 for a bf16 layer (whose bf16 products, exact in f32,
// TF32 computes exactly). The next stage is prepared while the tensor cores
// run this one. Writes w_part[split * w_len + natural offset + k Np + n], b
// after W. Blocks run layer by layer, split by split, tile by tile, so the
// blocks resident together are the tiles of a few splits of one layer and
// stream the same rows.
__global__ void __launch_bounds__(ENF_THREADS, 1)
    coupling_dw_kernel(const float* __restrict__ scratch,
                       const __grid_constant__ CPlan plan, long long rows,
                       int nsplit, float* __restrict__ w_part,
                       long long w_len) {
  extern __shared__ __align__(128) unsigned char wsmem[];
  unsigned char* smem = wsmem;
  int t = blockIdx.x, l = 0, tn = 1, tiles = 1;
  for (; l < plan.n_layers; ++l) {
    tn = (plan.layer[l][1] + ENF_DWN - 1) / ENF_DWN;
    tiles = (plan.layer[l][0] + ENF_DWM - 1) / ENF_DWM * tn;
    if (t < tiles * nsplit) break;
    t -= tiles * nsplit;
  }
  if (l >= plan.n_layers) return;
  const int* L = plan.layer[l];
  const int Kp = L[0], Np = L[1];
  const bool bf = L[7] != 0;
  const int s = t / tiles;
  t -= s * tiles;
  const int m0 = (t / tn) * ENF_DWM, n0 = (t % tn) * ENF_DWN;
  const int mr = min(ENF_DWM, Kp - m0), nc = min(ENF_DWN, Np - n0);
  const long long nch = rows / ENF_DWR;
  const long long c0 = nch * s / nsplit;
  const int nst = (int)(nch * (s + 1) / nsplit - c0);
  const float* hin = scratch + rows * L[5];
  const float* gp = scratch + rows * (L[5] + Kp);
  const Ring rg = ring_at(smem, ENF_DW_RING, ENF_DW_STAGE);
  __syncthreads();
  if (threadIdx.x >= ENF_CONS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == ENF_CONS) {
      const unsigned ab = mr * ENF_DWR * 4, bb = nc * ENF_DWR * 4;
      Pipe p{0, 0u};
      for (int st = 0; st < nst; ++st) {
        mbar_wait(&rg.empty[p.slot], p.phase ^ 1u);
        mbar_expect_tx(&rg.full[p.slot], ab + bb);
        const unsigned dst = rg.base + p.slot * ENF_DW_STAGE;
        const long long c = c0 + st;
        bulk_g2s(dst, hin + ((c * (Kp >> 3) + (m0 >> 3)) << 8), ab,
                 &rg.full[p.slot]);
        bulk_g2s(dst + 4 * ENF_DWR * ENF_DWM,
                 gp + ((c * (Np >> 3) + (n0 >> 3)) << 8), bb,
                 &rg.full[p.slot]);
        p.next(rg.n);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const bool bias = m0 == 0 && (int)threadIdx.x < nc;
  WAcc acc;
  acc.zero();
  float colsum = 0.f;
  // Column threadIdx.x of a stage's g_pre: summed (in f32, rows in order)
  // and rounded in place.
  auto prep = [&](int slot) {
    if ((int)threadIdx.x >= nc) return;
    float* col = reinterpret_cast<float*>(smem + ENF_BARS +
                                          slot * ENF_DW_STAGE +
                                          4 * ENF_DWR * ENF_DWM) +
                 (threadIdx.x >> 3) * 256 + (threadIdx.x & 7) * 4;
#pragma unroll
    for (int kc = 0; kc < ENF_DWR / 4; ++kc) {
      float4 v = *reinterpret_cast<float4*>(col + kc * 32);
      if (bias) {
        colsum += v.x;
        colsum += v.y;
        colsum += v.z;
        colsum += v.w;
      }
      v = make_float4(oprnd(v.x, bf), oprnd(v.y, bf), oprnd(v.z, bf),
                      oprnd(v.w, bf));
      *reinterpret_cast<float4*>(col + kc * 32) = v;
    }
  };
  switch (nb64(nc)) {
    case 1: dw_loop<1>(acc, rg, nst, prep); break;
    case 2: dw_loop<2>(acc, rg, nst, prep); break;
    case 3: dw_loop<3>(acc, rg, nst, prep); break;
    default: dw_loop<4>(acc, rg, nst, prep); break;
  }
  float* out = w_part + (size_t)s * w_len + L[6];
  const int wg = threadIdx.x >> 7, w4 = (threadIdx.x >> 5) & 3;
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < ENF_NBW; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + 64 * wg + 16 * w4 + g + 8 * h;
          const int nn = n0 + 64 * j + 8 * i + 2 * q + e;
          if (m < Kp && nn < Np)
            out[(size_t)m * Np + nn] = acc.v[j][4 * i + 2 * h + e];
        }
  if (bias) out[(size_t)Kp * Np + n0 + threadIdx.x] = colsum;
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
    for (int f = 0; f < 8; ++f) p->layer[l][f] = li[l * 8 + f];
    if (p->layer[l][0] < 8 || p->layer[l][0] % 8 || p->layer[l][1] < 8 ||
        p->layer[l][1] % 8 || (p->layer[l][7] && p->layer[l][0] % 16))
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
    // A coupling's layers take one path, TF32 or bf16.
    if (it[0] != K_ELEM) {
      const int bf = p->layer[it[5]][7];
      for (int l = it[5]; l < it[5] + it[4]; ++l)
        if (p->layer[l][7] != bf) return 1;
    }
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
    // B5 reads a bf16 slab at its depth padded to 16.
    if (p.layer[it[5]][7] && (it[10] + 15) / 16 * 16 + 4 > ldh) return false;
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
static int launch_fwd_wide(const void* x, void* y, void* ladj, const float* Wk,
                      const float* P, const CPlan& plan, long long n, int d,
                      int ldh, float* scratch, float* svs, int smem, int grid,
                      float shift, int bfio, cudaStream_t stream) {
  using G = Geo<MF, WM>;
  const long long need =
      4LL * (G::RING + (long long)G::TM * (2 * d + ldh));
  if (!tile_ok<MF, WM>(plan, d, ldh) || need > smem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      coupling_fwd_kernel_wide<MF, WM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  coupling_fwd_kernel_wide<MF, WM><<<grid, 32 * ENF_WARPS, smem, stream>>>(
      x, y, ladj, Wk, P, plan, n, d, ldh, scratch, svs, shift, bfio);
  return (int)cudaGetLastError();
}

// bf16io: the storage of x, y and ladj (0 float32, 1 bf16).
extern "C" int enf_coupling_fwd_wide(int bf16io, const void* x, void* y,
                                void* ladj, const float* Wk, const float* P,
                                const int* si, const float* sf, int n_items,
                                const int* li, int n_layers, long long n,
                                int d, int ldh, int tm, float* scratch,
                                float* svs, int smem, int grid, float shift,
                                void* stream) {
  CPlan plan;
  if (make_cplan(&plan, si, sf, n_items, li, n_layers))
    return (int)cudaErrorInvalidValue;
  if (tm != 16) return (int)cudaErrorInvalidValue;
  return launch_fwd_wide<1, 1>(x, y, ladj, Wk, P, plan, n, d, ldh, scratch,
                               svs, smem, grid, shift, bf16io,
                               (cudaStream_t)stream);
}

template <int MF, int WM>
static int launch_bwd_wide(const void* x, const void* gy, const void* gl,
                      void* gx, const float* Wk, const float* P,
                      const CPlan& plan, long long rows, int d, int ldh,
                      int smem, int grid, int n_pslots, float* scratch,
                      const float* svs, float* p_part, float shift, int bfio,
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
      coupling_bwd_kernel_wide<MF, WM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  coupling_bwd_kernel_wide<MF, WM><<<grid, 32 * ENF_WARPS, smem, stream>>>(
      x, gy, gl, gx, Wk, P, plan, rows, d, ldh, n_pslots, scratch, svs,
      p_part, shift, bfio);
  return (int)cudaGetLastError();
}

// bf16io: the storage of x, gy, gl and gx (0 float32, 1 bf16).
extern "C" int enf_coupling_bwd_wide(int bf16io, const void* x, const void* gy,
                                const void* gl, void* gx, const float* Wk,
                                const float* P, const int* si,
                                const float* sf, int n_items, const int* li,
                                int n_layers, long long rows, int d, int ldh,
                                int tm, int smem, int grid, int n_pslots,
                                float* scratch, const float* svs,
                                float* p_part, float shift, void* stream) {
  CPlan plan;
  if (make_cplan(&plan, si, sf, n_items, li, n_layers))
    return (int)cudaErrorInvalidValue;
  if (tm != 16) return (int)cudaErrorInvalidValue;
  return launch_bwd_wide<1, 1>(x, gy, gl, gx, Wk, P, plan, rows, d, ldh, smem,
                               grid, n_pslots, scratch, svs, p_part, shift,
                               bf16io, (cudaStream_t)stream);
}

extern "C" int enf_coupling_dw_wide(const float* scratch, const int* li,
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
    for (int f = 0; f < 8; ++f) plan.layer[l][f] = li[l * 8 + f];
    const int Kp = plan.layer[l][0], Np = plan.layer[l][1];
    if (Kp % 8 || Np % 8) return (int)cudaErrorInvalidValue;
    tiles += (Kp + ENF_DW_TILE - 1) / ENF_DW_TILE *
             ((Np + ENF_DW_TILE - 1) / ENF_DW_TILE);
  }
  cudaError_t err = cudaFuncSetAttribute(
      coupling_dw_kernel_wide, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(tiles, nsplit);
  coupling_dw_kernel_wide<<<grid, 256, smem, (cudaStream_t)stream>>>(
      scratch, plan, rows, nsplit, w_part, w_len);
  return (int)cudaGetLastError();
}

// The Hopper path's launches.

// Whether the 64-row kernels take the plan: every pass within two
// warpgroups' 512 columns and one ring slot, every layer input, hidden
// output and B5 slab depth within H's lda values, every slab within ldo.
static bool wg_ok(const CPlan& p, int d, int lda, int ldo, int nring,
                  int slot_bytes) {
  if (d < 2 || d % 2 || lda < 16 || lda % 16 || ldo < 8 || ldo % 8 ||
      nring < 2 || nring > ENF_MAX_RING || slot_bytes % 2048)
    return false;
  const int maxnb = slot_bytes / 2048 < 2 * ENF_NBW ? slot_bytes / 2048
                                                     : 2 * ENF_NBW;
  for (int i = 0; i < p.n_items; ++i) {
    const int* it = p.item[i];
    if (it[0] == K_ELEM) continue;
    const int* L0 = p.layer[it[5]];
    const int sw = it[10], sk = L0[7] ? (sw + 15) / 16 * 16 : sw;
    if (L0[0] < d / 2 || sw > ldo || sk > lda || nb64(sw) > maxnb)
      return false;
    for (int l = it[5]; l < it[5] + it[4]; ++l) {
      if (p.layer[l][0] > lda || nb64(p.layer[l][0]) > maxnb) return false;
      if (l + 1 < it[5] + it[4] &&
          (p.layer[l][1] > lda || nb64(p.layer[l][1]) > maxnb ||
           p.layer[l][1] != p.layer[l + 1][0]))
        return false;
    }
  }
  return true;
}

// bf16io: the storage of x, y and ladj (0 float32, 1 bf16). rows: the rows
// of scratch and svs (a multiple of 64, at least n), when given.
extern "C" int enf_coupling_fwd(int bf16io, const void* x, void* y,
                                void* ladj, const float* Wk, const float* P,
                                const int* si, const float* sf, int n_items,
                                const int* li, int n_layers, long long n,
                                long long rows, int d, int lda, int ldo,
                                int nring, int slot_bytes, float* scratch,
                                float* svs, int smem, int grid, float shift,
                                void* stream) {
  CPlan plan;
  if (make_cplan(&plan, si, sf, n_items, li, n_layers) ||
      !wg_ok(plan, d, lda, ldo, nring, slot_bytes) ||
      (scratch && (rows % ENF_TM || rows < n)))
    return (int)cudaErrorInvalidValue;
  const long long need = ENF_BARS + (long long)nring * slot_bytes +
                         plan_hr(plan, lda) + 4LL * ENF_TM * (d + ldo + 1);
  if (need > smem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      coupling_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  coupling_fwd_kernel<<<grid, ENF_THREADS, smem, (cudaStream_t)stream>>>(
      x, y, ladj, Wk, P, plan, n, rows, d, lda, ldo, nring, slot_bytes,
      scratch, svs, shift, bf16io);
  return (int)cudaGetLastError();
}

// bf16io: the storage of x, gy, gl and gx (0 float32, 1 bf16). rows: the
// rows of scratch and svs (a multiple of 64, at least n). recompute: 1
// when B5 recomputes the forward and writes scratch and svs itself.
extern "C" int enf_coupling_bwd(int bf16io, const void* x, const void* gy,
                                const void* gl, void* gx, const float* Wk,
                                const float* P, const int* si,
                                const float* sf, int n_items, const int* li,
                                int n_layers, long long n, long long rows,
                                int d, int lda, int ldo, int nring,
                                int slot_bytes, int smem, int grid,
                                int n_pslots, float* scratch, float* svs,
                                int recompute, float* p_part, float shift,
                                void* stream) {
  CPlan plan;
  if (make_cplan(&plan, si, sf, n_items, li, n_layers) ||
      !wg_ok(plan, d, lda, ldo, nring, slot_bytes) || rows % ENF_TM ||
      rows < n || !scratch || !svs)
    return (int)cudaErrorInvalidValue;
  const long long need =
      ENF_BARS + (long long)nring * slot_bytes +
      plan_hr_bwd(plan, lda, ldo) +
      4LL * (ENF_TM * ((long long)d + 1 + (recompute ? ldo : 0)) +
             (long long)n_pslots * d);
  if (need > smem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      coupling_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  coupling_bwd_kernel<<<grid, ENF_THREADS, smem, (cudaStream_t)stream>>>(
      x, gy, gl, gx, Wk, P, plan, n, rows, d, lda, ldo, nring, slot_bytes,
      n_pslots, scratch, svs, recompute, p_part, shift, bf16io);
  return (int)cudaGetLastError();
}

// rows: the scratch's rows (a multiple of 64). One block per split of each
// 128 x 256 tile of each layer's dW.
extern "C" int enf_coupling_dw(const float* scratch, const int* li,
                               int n_layers, long long rows, int nsplit,
                               float* w_part, long long w_len, int smem,
                               void* stream) {
  CPlan plan = CPlan{};
  if (n_layers < 1 || n_layers > ENF_CMAX_LAYERS || nsplit < 1 ||
      rows % ENF_TM || smem < ENF_BARS + ENF_DW_RING * ENF_DW_STAGE)
    return (int)cudaErrorInvalidValue;
  plan.n_layers = n_layers;
  long long blocks = 0;
  for (int l = 0; l < n_layers; ++l) {
    for (int f = 0; f < 8; ++f) plan.layer[l][f] = li[l * 8 + f];
    const int Kp = plan.layer[l][0], Np = plan.layer[l][1];
    if (Kp < 8 || Kp % 8 || Np < 8 || Np % 8) return (int)cudaErrorInvalidValue;
    blocks += (long long)((Kp + ENF_DWM - 1) / ENF_DWM) *
              ((Np + ENF_DWN - 1) / ENF_DWN) * nsplit;
  }
  cudaError_t err = cudaFuncSetAttribute(
      coupling_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  coupling_dw_kernel<<<(unsigned)blocks, ENF_THREADS, smem,
                       (cudaStream_t)stream>>>(scratch, plan, rows, nsplit,
                                               w_part, w_len);
  return (int)cudaGetLastError();
}
