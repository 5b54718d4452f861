// Fused bijector-chain kernels for Hopper (sm_90a): B1 forward+ladj,
// B2 its backward, B3 the single-pass whitening loss + gradient.
//
// Replace the Pallas TPU kernels of enflows_tpu/ops/pallas/elementwise.py:
//   B1 fused_fwd_kernel  <- _fused_packed_impl     (kernel _build_kernel)
//   B2 fused_grad_kernel<false> <- _fused_packed_bwd_impl (_build_bwd_kernel)
//   B3 fused_grad_kernel<true>  <- _fused_negll_grad_impl (_build_negll_grad_kernel)
//
// What is computed is the TPU kernels' math, not their layout. A contiguous
// (n, d) f32 tensor is already row-major flat, so there is no packing, no
// event padding and no block-diagonal Householder: a block owns a tile of
// whole samples, staged in shared memory, and masks the ragged last tile by
// bounds checks.
//
// The chain arrives at run time as a Plan (stages.cuh; Pallas traced one
// kernel per chain); parameter slot q holds a (d,) vector at
// P[q*d .. q*d+d). A Householder stage is y = x Q^T (Q = product of
// reflections, built by the caller, which also passes Qt = Q^T for the
// forward product); it adds nothing to the ladj.
//
// The stage adjoints are derived by hand (the TPU kernels called jax.vjp on
// the stage bodies at trace time). stage_bwd follows the torch functions
// _adjoint_* in enflows_tpu_torch/ops/elementwise.py line by line; those
// are checked against autograd on the CPU.
//
// What bounds them on an H100: B1 and B3 are single passes over device
// memory. B1 reads 4 B and writes 4 B per element plus 4 B of ladj per
// sample; B3 reads 4 B per element and writes only per-block partials; B2
// reads x and gy and writes gx (12 B per element). Per CenterStretch
// element the transcendentals are about 1 exp + 2 log + 1 sqrt (forward),
// which at small d puts the arithmetic near the memory time. The design
// answers that by touching device memory once per element and keeping every
// intermediate (each stage's input, the cotangents, the per-dimension
// gradient sums) in shared memory; the parameter gradients are reduced in
// the block and written once per block, with no atomics, so results are
// deterministic for a given grid. This first version uses plain f32 FMAs
// (no tensor cores, no TF32: the Householder product must stay full f32),
// and no TMA or asynchronous copies.

#include <cuda_runtime.h>

#include "stages.cuh"

// B1: replaces _fused_packed_impl (ops/pallas/elementwise.py:441-507).
// Bound: device memory, 8 B per element plus 4 B per sample of ladj, and
// the transcendentals of the stage bodies. Design: each element is read and
// written once; the chain runs on a shared-memory tile between the two, and
// the per-sample ladj is a shared-memory sum over the sample's d elements.
// Shared memory: two ping-pong tiles and the per-element ladj sums,
// 3 * tile * d floats. Grid-stride loop over tiles of `tile` samples.
__global__ void fused_fwd_kernel(const float* __restrict__ x,
                                 float* __restrict__ y,
                                 float* __restrict__ ladj,
                                 const float* __restrict__ P,
                                 const float* __restrict__ Qt, Plan plan,
                                 long long n, int d, int tile) {
  extern __shared__ float smem[];
  const int TD = tile * d;
  float* buf0 = smem;
  float* buf1 = smem + TD;
  float* acc = smem + 2 * TD;
  const long long ntiles = (n + tile - 1) / tile;
  for (long long ti = blockIdx.x; ti < ntiles; ti += gridDim.x) {
    const long long s0 = ti * tile;
    const int ns = (int)min((long long)tile, n - s0);
    const int ne = ns * d;
    const float* xt = x + s0 * d;
    float* t = buf0;
    float* o = buf1;
    for (int e = threadIdx.x; e < ne; e += blockDim.x) {
      t[e] = xt[e];
      acc[e] = 0.f;
    }
    for (int k = 0; k < plan.n_stages; ++k) {
      const int code = plan.code[k], arg = plan.arg[k];
      if (code == HH) {
        __syncthreads();
        householder_apply(t, o, Qt + (size_t)arg * d * d, ne, d);
        __syncthreads();
        float* sw = t;
        t = o;
        o = sw;
      } else {
        for (int e = threadIdx.x; e < ne; e += blockDim.x) {
          float el;
          t[e] = stage_fwd(code, t[e], P, arg, d, e % d, &el);
          acc[e] += el;
        }
      }
    }
    float* yt = y + s0 * d;
    for (int e = threadIdx.x; e < ne; e += blockDim.x) yt[e] = t[e];
    __syncthreads();
    for (int s = threadIdx.x; s < ns; s += blockDim.x) {
      float sum = 0.f;
      for (int j = 0; j < d; ++j) sum += acc[s * d + j];
      ladj[s0 + s] = sum;
    }
    __syncthreads();
  }
}

// B2 (NEGLL = false): replaces _fused_packed_bwd_impl
// (ops/pallas/elementwise.py:641-743). Bound: device memory, x and gy read
// and gx written (12 B per element, 4 B per sample of gladj), plus the
// forward recomputed and the adjoints. B3 (NEGLL = true): replaces
// _fused_negll_grad_impl (ops/pallas/elementwise.py:852-906). Bound: x read
// once (4 B per element), no y or gx written, the forward and adjoint
// transcendentals. Design of both: the forward is recomputed on the tile
// with every stage's input kept in shared memory, the adjoint sweep runs in
// place there, and the parameter gradients are summed in the block and
// written once per block.
//
// Shared memory, in floats: (n_stages + 1) tiles holding each stage's input
// and the output; n_pslots tiles of per-element parameter-gradient sums,
// carried across the block's tiles; for B3 one tile of loss sums; 32 for the
// final reduction. The Householder cotangents dQ[j, k] = sum_s cy[s, j]
// t_in[s, k] go straight to this block's own slot of q_part, split into
// `groups` interleaved sample groups so that small d keeps every thread busy
// (the block is the only writer of its slot, so no atomics).
//
// Outputs: p_part (grid, n_pslots * d), q_part (grid, n_hh, groups, d, d),
// zeroed by the caller; B3: loss_part (grid,), unscaled sums of
// logpdf(y) + ladj, with c_y = y and c_e = -1 (the caller scales by 1/n);
// B2: gx (n, d) from the cotangents gy (n, d) and gladj (n,).
template <bool NEGLL>
__global__ void fused_grad_kernel(const float* __restrict__ x,
                                  const float* __restrict__ gy,
                                  const float* __restrict__ gladj,
                                  float* __restrict__ gx,
                                  const float* __restrict__ P,
                                  const float* __restrict__ Q,
                                  const float* __restrict__ Qt, Plan plan,
                                  long long n, int d, int tile, int n_pslots,
                                  int n_hh, int groups,
                                  float* __restrict__ loss_part,
                                  float* __restrict__ p_part,
                                  float* __restrict__ q_part) {
  extern __shared__ float smem[];
  const int TD = tile * d;
  const int nst = plan.n_stages;
  float* ins = smem;
  float* pacc = ins + (size_t)(nst + 1) * TD;
  float* lacc = pacc + (size_t)n_pslots * TD;
  float* red = lacc + (NEGLL ? TD : 0);
  const int dd = d * d;
  float* qblk = q_part + (size_t)blockIdx.x * n_hh * groups * dd;

  for (int i = threadIdx.x; i < n_pslots * TD; i += blockDim.x) pacc[i] = 0.f;
  if (NEGLL)
    for (int i = threadIdx.x; i < TD; i += blockDim.x) lacc[i] = 0.f;

  const long long ntiles = (n + tile - 1) / tile;
  for (long long ti = blockIdx.x; ti < ntiles; ti += gridDim.x) {
    const long long s0 = ti * tile;
    const int ns = (int)min((long long)tile, n - s0);
    const int ne = ns * d;
    const float* xt = x + s0 * d;
    for (int e = threadIdx.x; e < ne; e += blockDim.x) ins[e] = xt[e];

    // Forward, keeping every stage's input.
    for (int k = 0; k < nst; ++k) {
      const int code = plan.code[k], arg = plan.arg[k];
      const float* in = ins + (size_t)k * TD;
      float* out = ins + (size_t)(k + 1) * TD;
      if (code == HH) {
        __syncthreads();
        householder_apply(in, out, Qt + (size_t)arg * dd, ne, d);
        __syncthreads();
      } else {
        for (int e = threadIdx.x; e < ne; e += blockDim.x) {
          float el;
          out[e] = stage_fwd(code, in[e], P, arg, d, e % d, &el);
          if (NEGLL) lacc[e] += el;
        }
      }
    }

    // Output cotangents, written over y.
    float* cy = ins + (size_t)nst * TD;
    for (int e = threadIdx.x; e < ne; e += blockDim.x) {
      if (NEGLL) {
        const float yv = cy[e];
        lacc[e] += -0.5f * (yv * yv + ENF_LOG_2PI);
      } else {
        cy[e] = gy[s0 * d + e];
      }
    }

    // Reverse sweep of the stage adjoints.
    for (int k = nst - 1; k >= 0; --k) {
      const int code = plan.code[k], arg = plan.arg[k];
      float* in = ins + (size_t)k * TD;
      if (code == HH) {
        const float* Qk = Q + (size_t)arg * dd;
        float* qk = qblk + (size_t)arg * groups * dd;
        __syncthreads();
        for (int idx = threadIdx.x; idx < groups * dd; idx += blockDim.x) {
          const int grp = idx / dd, jk = idx - grp * dd;
          const int j = jk / d, kk = jk - j * d;
          float sum = 0.f;
          for (int s = grp; s < ns; s += groups)
            sum = fmaf(cy[s * d + j], in[s * d + kk], sum);
          qk[idx] += sum;
        }
        __syncthreads();
        // The input cotangent ct[s, k] = sum_j cy[s, j] Q[j, k] replaces
        // this stage's input, which nothing needs any more.
        householder_apply(cy, in, Qk, ne, d);
        __syncthreads();
        cy = in;
      } else {
        const int np = n_params(code);
        for (int e = threadIdx.x; e < ne; e += blockDim.x) {
          const float ce = NEGLL ? -1.f : __ldg(gladj + s0 + e / d);
          float g[4];
          cy[e] = stage_bwd(code, in[e], P, arg, d, e % d, cy[e], ce, g);
          for (int i = 0; i < np; ++i) pacc[(size_t)(arg + i) * TD + e] += g[i];
        }
      }
    }

    if (!NEGLL) {
      __syncthreads();
      float* gxt = gx + s0 * d;
      for (int e = threadIdx.x; e < ne; e += blockDim.x) gxt[e] = cy[e];
    }
    __syncthreads();
  }

  // Block epilogue: fold the per-element sums over the tile's samples.
  __syncthreads();
  for (int idx = threadIdx.x; idx < n_pslots * d; idx += blockDim.x) {
    const int q = idx / d, j = idx - q * d;
    const float* col = pacc + (size_t)q * TD + j;
    float sum = 0.f;
    for (int s = 0; s < tile; ++s) sum += col[s * d];
    p_part[(size_t)blockIdx.x * n_pslots * d + idx] = sum;
  }
  if (NEGLL) {
    float v = 0.f;
    for (int e = threadIdx.x; e < TD; e += blockDim.x) v += lacc[e];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
      float sum = 0.f;
      for (int w = 0; w < (int)(blockDim.x + 31) / 32; ++w) sum += red[w];
      loss_part[blockIdx.x] = sum;
    }
  }
}

// C interface. Each function launches on `stream`, does not synchronize, and
// returns cudaGetLastError() after the launch (0 on success).
extern "C" const char* enf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int enf_fused_fwd(const float* x, float* y, float* ladj,
                             const float* P, const float* Qt,
                             const int* codes, const int* args, int n_stages,
                             long long n, int d, int tile, int grid,
                             int block, int smem, void* stream) {
  Plan plan;
  if (make_plan(&plan, codes, args, n_stages)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fused_fwd_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      x, y, ladj, P, Qt, plan, n, d, tile);
  return (int)cudaGetLastError();
}

template <bool NEGLL>
static int launch_grad(const float* x, const float* gy, const float* gladj,
                       float* gx, const float* P, const float* Q,
                       const float* Qt, const int* codes, const int* args,
                       int n_stages,
                       long long n, int d, int tile, int grid, int block,
                       int smem, int n_pslots, int n_hh, int groups,
                       float* loss_part, float* p_part, float* q_part,
                       void* stream) {
  Plan plan;
  if (make_plan(&plan, codes, args, n_stages)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_grad_kernel<NEGLL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  fused_grad_kernel<NEGLL><<<grid, block, smem, (cudaStream_t)stream>>>(
      x, gy, gladj, gx, P, Q, Qt, plan, n, d, tile, n_pslots, n_hh, groups,
      loss_part, p_part, q_part);
  return (int)cudaGetLastError();
}

extern "C" int enf_fused_bwd(const float* x, const float* gy,
                             const float* gladj, float* gx, const float* P,
                             const float* Q, const float* Qt,
                             const int* codes, const int* args, int n_stages,
                             long long n,
                             int d, int tile, int grid, int block, int smem,
                             int n_pslots, int n_hh, int groups,
                             float* p_part, float* q_part, void* stream) {
  return launch_grad<false>(x, gy, gladj, gx, P, Q, Qt, codes, args,
                            n_stages, n, d, tile, grid, block, smem,
                            n_pslots, n_hh, groups, nullptr, p_part, q_part,
                            stream);
}

extern "C" int enf_fused_negll(const float* x, const float* P,
                               const float* Q, const float* Qt,
                               const int* codes, const int* args,
                               int n_stages, long long n,
                               int d, int tile, int grid, int block,
                               int smem, int n_pslots, int n_hh, int groups,
                               float* loss_part, float* p_part,
                               float* q_part, void* stream) {
  return launch_grad<true>(x, nullptr, nullptr, nullptr, P, Q, Qt, codes,
                           args, n_stages, n, d, tile, grid, block, smem,
                           n_pslots, n_hh, groups, loss_part, p_part, q_part,
                           stream);
}
