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
// The chain arrives at run time (Pallas traced one kernel per chain):
//   plan.code[k]  stage kind (SS, CC, CS, JF, JI, HH below);
//   plan.arg[k]   elementwise stage: its first parameter slot in P, where
//                 slot q holds a (d,) vector at P[q*d .. q*d+d);
//                 Householder stage: the index of its (d, d) Q in Q.
// A Householder stage is y = x Q^T (Q = product of reflections, built by
// the caller); it adds nothing to the ladj.
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

#define ENF_MAX_STAGES 32

enum { SS = 0, CC = 1, CS = 2, JF = 3, JI = 4, HH = 5 };

struct Plan {
  int n_stages;
  int code[ENF_MAX_STAGES];
  int arg[ENF_MAX_STAGES];
};

#define ENF_LOG2 0.6931471805599453f
#define ENF_LOG_2PI 1.8378770664093453f

__device__ __forceinline__ float par(const float* __restrict__ P, int slot,
                                     int d, int j) {
  return __ldg(P + (size_t)slot * d + j);
}

__device__ __forceinline__ float sgnf(float v) {
  return (float)((v > 0.f) - (v < 0.f));
}

__device__ __forceinline__ int n_params(int code) {
  return code == SS ? 2 : (code == CC || code == CS) ? 3 : 4;
}

// One stage's forward at one element: returns y, writes the elementwise
// ladj term. Mirrors _apply_* of ops/pallas/elementwise.py:153-225.
__device__ __forceinline__ float stage_fwd(int code, float t,
                                           const float* __restrict__ P,
                                           int slot, int d, int j,
                                           float* elem) {
  if (code == SS) {
    const float a = par(P, slot, d, j), b = par(P, slot + 1, d, j);
    *elem = logf(fabsf(a));
    return t * a + b;
  }
  if (code == CC) {
    const float a = par(P, slot, d, j), b = par(P, slot + 1, d, j),
                c = par(P, slot + 2, d, j);
    const float xu = t - c;
    const float u1 = b * (xu - a), u2 = b * (xu + a);
    const float e1 = expf(-fabsf(u1)), e2 = expf(-fabsf(u2));
    const float sp1 = fmaxf(u1, 0.f) + log1pf(e1);
    const float sp2 = fmaxf(-u2, 0.f) + log1pf(e2);
    const float s1 = (u1 >= 0.f ? 1.f : e1) / (1.f + e1);
    const float s2 = (-u2 >= 0.f ? 1.f : e2) / (1.f + e2);
    *elem = logf(s1 + s2);
    return (sp1 - sp2) / b;
  }
  if (code == CS) {
    const float a = par(P, slot, d, j), b = par(P, slot + 1, d, j),
                c = par(P, slot + 2, d, j);
    const float ab = a * b;
    const float m = fmaxf(fabsf(b * t), 1e-6f);
    const float em = expf(-m);
    const float one_m = 1.f - em;
    const float c1 = 4.f * expf(-2.f * ab);
    const float r = sqrtf(one_m * one_m + c1 * em);
    const float denom = one_m + r;
    const float log_s = m + ab - ENF_LOG2 + logf(denom);
    const float ae = 2.f * em / denom;
    const float a2 = expf(2.f * ab);
    const float s_sum = 1.f / (1.f + ae) + ae / (ae + a2);
    *elem = -logf(s_sum);
    return c + sgnf(t) * log_s / b;
  }
  if (code == JF) {
    const float gamma = par(P, slot, d, j), delta = par(P, slot + 1, d, j),
                xi = par(P, slot + 2, d, j), lam = par(P, slot + 3, d, j);
    const float u = (t - xi) / lam;
    const float s = sqrtf(1.f + u * u);
    const float asinh_u = sgnf(u) * logf(fabsf(u) + s);
    *elem = logf(fabsf(delta / lam)) - logf(s);
    return gamma + delta * asinh_u;
  }
  // JI
  const float gamma = par(P, slot, d, j), delta = par(P, slot + 1, d, j),
              xi = par(P, slot + 2, d, j), lam = par(P, slot + 3, d, j);
  const float v = (t - gamma) / delta;
  const float av = fabsf(v);
  const float ei = expf(-av);
  const float e = 1.f / ei;
  const float sinh_v = sgnf(v) * 0.5f * (e - ei);
  *elem = logf(fabsf(lam / delta)) + av + log1pf(ei * ei) - ENF_LOG2;
  return lam * sinh_v + xi;
}

// One stage's adjoint at one element. t: the stage input; cy, ce: the
// cotangents of the output and of the elementwise ladj term. Returns the
// input cotangent, writes one gradient term per parameter into g.
// Follows _adjoint_* in ops/elementwise.py.
__device__ __forceinline__ float stage_bwd(int code, float t,
                                           const float* __restrict__ P,
                                           int slot, int d, int j, float cy,
                                           float ce, float* g) {
  if (code == SS) {
    const float a = par(P, slot, d, j);
    g[0] = cy * t + ce / a;
    g[1] = cy;
    return cy * a;
  }
  if (code == CC) {
    const float a = par(P, slot, d, j), b = par(P, slot + 1, d, j),
                c = par(P, slot + 2, d, j);
    const float xu = t - c;
    const float u1 = b * (xu - a), u2 = b * (xu + a);
    const float e1 = expf(-fabsf(u1)), e2 = expf(-fabsf(u2));
    const float sp1 = fmaxf(u1, 0.f) + log1pf(e1);
    const float sp2 = fmaxf(-u2, 0.f) + log1pf(e2);
    const float y = (sp1 - sp2) / b;
    const float s1 = (u1 >= 0.f ? 1.f : e1) / (1.f + e1);
    const float s2 = (-u2 >= 0.f ? 1.f : e2) / (1.f + e2);
    const float p1 = e1 / ((1.f + e1) * (1.f + e1));
    const float p2 = e2 / ((1.f + e2) * (1.f + e2));
    const float S = s1 + s2;
    const float ct = cy * S + ce * b * (p1 - p2) / S;
    g[0] = cy * (s2 - s1) - ce * b * (p1 + p2) / S;
    g[1] = cy * (s1 * (xu - a) + s2 * (xu + a) - y) / b
           + ce * (p1 * (xu - a) - p2 * (xu + a)) / S;
    g[2] = -ct;
    return ct;
  }
  if (code == CS) {
    // Implicit differentiation of y = g^{-1}(t), g = center_contract, at the
    // forward's own intermediates: with w = |b (y - c)| = log_s and
    // ae = e^{ab - w}, q = ae e^{-2ab}, the two contract sigmoids at y are
    // A = 1/(1+ae) and B = q/(1+q) (swapped for t < 0).
    const float a = par(P, slot, d, j), b = par(P, slot + 1, d, j);
    const float ab = a * b;
    const float m = fmaxf(fabsf(b * t), 1e-6f);
    const float em = expf(-m);
    const float one_m = 1.f - em;
    const float c1 = 4.f * expf(-2.f * ab);
    const float r = sqrtf(one_m * one_m + c1 * em);
    const float denom = one_m + r;
    const float log_s = m + ab - ENF_LOG2 + logf(denom);
    const float sg = sgnf(t);
    const float yu = sg * log_s / b;
    const float ae = 2.f * em / denom;
    const float q = 0.25f * ae * c1;
    const float A = 1.f / (1.f + ae), B = q / (1.f + q);
    const float pA = A * A * ae, pB = B / (1.f + q);
    const float s1 = sg >= 0.f ? A : B, s2 = sg >= 0.f ? B : A;
    const float p1 = sg >= 0.f ? pA : pB, p2 = sg >= 0.f ? pB : pA;
    const float S = s1 + s2;
    const float Sy = b * (p1 - p2);
    const float dy_dt = 1.f / S;
    const float dy_da = (s1 - s2) / S;
    const float dy_db = -(s1 * (yu - a) + s2 * (yu + a) - t) / (b * S);
    const float dE_dt = -Sy / (S * S);
    const float dE_da = -(Sy * dy_da - b * (p1 + p2)) / S;
    const float dE_db = -(Sy * dy_db + p1 * (yu - a) - p2 * (yu + a)) / S;
    g[0] = cy * dy_da + ce * dE_da;
    g[1] = cy * dy_db + ce * dE_db;
    g[2] = cy;
    return cy * dy_dt + ce * dE_dt;
  }
  if (code == JF) {
    const float delta = par(P, slot + 1, d, j), xi = par(P, slot + 2, d, j),
                lam = par(P, slot + 3, d, j);
    const float u = (t - xi) / lam;
    const float s = sqrtf(1.f + u * u);
    const float asinh_u = sgnf(u) * logf(fabsf(u) + s);
    const float cu = cy * delta / s - ce * u / (s * s);
    const float ct = cu / lam;
    g[0] = cy;
    g[1] = cy * asinh_u + ce / delta;
    g[2] = -ct;
    g[3] = -(cu * u + ce) / lam;
    return ct;
  }
  // JI
  const float gamma = par(P, slot, d, j), delta = par(P, slot + 1, d, j),
              lam = par(P, slot + 3, d, j);
  const float v = (t - gamma) / delta;
  const float ei = expf(-fabsf(v));
  const float e = 1.f / ei;
  const float sg = sgnf(v);
  const float sinh_v = sg * 0.5f * (e - ei);
  const float cosh_v = 0.5f * (e + ei);
  const float tanh_v = sg * (1.f - ei * ei) / (1.f + ei * ei);
  const float cv = cy * lam * cosh_v + ce * tanh_v;
  const float ct = cv / delta;
  g[0] = -ct;
  g[1] = -(cv * v + ce) / delta;
  g[2] = cy;
  g[3] = cy * sinh_v + ce / lam;
  return ct;
}

// out[s, j] = sum_k in[s, k] * Q[j, k] over the tile's ne = ns * d elements.
__device__ __forceinline__ void householder_apply(const float* in, float* out,
                                                  const float* __restrict__ Q,
                                                  int ne, int d) {
  for (int e = threadIdx.x; e < ne; e += blockDim.x) {
    const int s = e / d, j = e - s * d;
    const float* row = in + s * d;
    const float* qrow = Q + (size_t)j * d;
    float acc = 0.f;
    for (int k = 0; k < d; ++k) acc = fmaf(row[k], __ldg(qrow + k), acc);
    out[e] = acc;
  }
}

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
                                 const float* __restrict__ Q, Plan plan,
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
        householder_apply(t, o, Q + (size_t)arg * d * d, ne, d);
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
                                  const float* __restrict__ Q, Plan plan,
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
        householder_apply(in, out, Q + (size_t)arg * dd, ne, d);
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
        for (int e = threadIdx.x; e < ne; e += blockDim.x) {
          const int s = e / d, kk = e - s * d;
          float acc = 0.f;
          for (int j = 0; j < d; ++j)
            acc = fmaf(cy[s * d + j], __ldg(Qk + (size_t)j * d + kk), acc);
          in[e] = acc;
        }
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

static int make_plan(Plan* plan, const int* codes, const int* args,
                     int n_stages) {
  if (n_stages < 0 || n_stages > ENF_MAX_STAGES) return 1;
  plan->n_stages = n_stages;
  for (int k = 0; k < ENF_MAX_STAGES; ++k) {
    plan->code[k] = k < n_stages ? codes[k] : 0;
    plan->arg[k] = k < n_stages ? args[k] : 0;
  }
  return 0;
}

// C interface. Each function launches on `stream`, does not synchronize, and
// returns cudaGetLastError() after the launch (0 on success).
extern "C" const char* enf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int enf_fused_fwd(const float* x, float* y, float* ladj,
                             const float* P, const float* Q,
                             const int* codes, const int* args, int n_stages,
                             long long n, int d, int tile, int grid,
                             int block, int smem, void* stream) {
  Plan plan;
  if (make_plan(&plan, codes, args, n_stages)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fused_fwd_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      x, y, ladj, P, Q, plan, n, d, tile);
  return (int)cudaGetLastError();
}

template <bool NEGLL>
static int launch_grad(const float* x, const float* gy, const float* gladj,
                       float* gx, const float* P, const float* Q,
                       const int* codes, const int* args, int n_stages,
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
      x, gy, gladj, gx, P, Q, plan, n, d, tile, n_pslots, n_hh, groups,
      loss_part, p_part, q_part);
  return (int)cudaGetLastError();
}

extern "C" int enf_fused_bwd(const float* x, const float* gy,
                             const float* gladj, float* gx, const float* P,
                             const float* Q, const int* codes,
                             const int* args, int n_stages, long long n,
                             int d, int tile, int grid, int block, int smem,
                             int n_pslots, int n_hh, int groups,
                             float* p_part, float* q_part, void* stream) {
  return launch_grad<false>(x, gy, gladj, gx, P, Q, codes, args, n_stages,
                            n, d, tile, grid, block, smem, n_pslots, n_hh,
                            groups, nullptr, p_part, q_part, stream);
}

extern "C" int enf_fused_negll(const float* x, const float* P,
                               const float* Q, const int* codes,
                               const int* args, int n_stages, long long n,
                               int d, int tile, int grid, int block,
                               int smem, int n_pslots, int n_hh, int groups,
                               float* loss_part, float* p_part,
                               float* q_part, void* stream) {
  return launch_grad<true>(x, nullptr, nullptr, nullptr, P, Q, codes, args,
                           n_stages, n, d, tile, grid, block, smem, n_pslots,
                           n_hh, groups, loss_part, p_part, q_part, stream);
}
