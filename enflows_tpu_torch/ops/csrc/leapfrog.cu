// Fused leapfrog + log-prob kernel for Hopper (sm_90a): B6.
//
// Replaces the Pallas TPU kernel of enflows_tpu/ops/pallas/leapfrog.py:
//   B6 leapfrog_kernel <- _fused_leapfrog_impl (kernel _build_leapfrog_kernel,
//                         sweep _chain_fwd_bwd)
//
// L velocity-Verlet steps of every chain with a diagonal inverse mass im, on
// logp(q) = sum_j N(f(q)_j; mu_j, 1 / iv_j) + ladj_f(q) for a fusible chain f
// (the stages of elementwise.cu, passed as the same Plan). Each gradient is
// the chain forward, keeping every stage's input, then the adjoint sweep
// with the analytic cotangents cy = -(y - mu) iv and ce = 1 (stage_bwd of
// stages.cuh). No parameter gradients: no atomics, no partial sums, and a
// deterministic result. A trajectory takes L + 1 gradients, one at q_0 and
// one per step; logp_0 comes from the first forward and logp_L from the last
// step's (the TPU kernel sweeps the chain a third time for it).
//
// Layout: one block owns a tile of `tile` chains for the whole trajectory.
// q, p and every stage's input stay in shared memory across all L steps, so
// device memory is read once (q_0, p_0, the parameters, and eps from a
// device pointer: a sampler's step size never visits the host) and written
// once (q_L, p_L, logp_0, logp_L). Shared memory per chain: (n_stages + 4) d
// floats, namely q, p, the per-element log-density terms and the n_stages + 1
// stage inputs and output; the gradient lives in one of the latter. A
// Householder stage is y = x Q^T: householder_apply (x M) with M = Qt = Q^T
// (passed by the wrapper) forward and with M = Q for the cotangent.
//
// What bounds it on an H100: operations. At the BASELINE leapfrog config
// (8192 chains, d = 50, L = 64, one 4-reflection Householder stage) the state
// moves once (6.6 MB), against 2 (L + 1) Householder products per chain and
// stage, which the function needs at 4 d FLOP per reflection (this kernel
// spends 2 d^2 on a product, through the dense Q), and the elementwise
// stages' transcendentals, which the adjoint recomputes. Grid: the wrapper
// picks tile = ceil(n / (2 * SMs)) chains, capped by the shared memory a
// block may hold, so that the grid
// covers the card twice where n allows: 8192 chains give 256 blocks of 32
// chains (44.8 KB each at d = 50 with 3 stages) over 132 SMs. A chain whose
// (n_stages + 4) d floats exceed the card's 227 KB per block is refused by
// the wrapper's predicate. This first version uses plain f32 FMAs (no tensor
// cores: the Householder product must stay full f32) and no asynchronous
// copies.

#include <cuda_runtime.h>

#include "stages.cuh"

// One gradient of logp at the q held in ins[0]. The chain forward keeps
// stage k's input in ins[k] and writes its output y to ins[n_stages]; the
// output cotangent replaces y and the adjoint sweep runs from there, each
// Householder stage writing its input cotangent over its own input. Returns
// the buffer that holds the gradient. With lacc, also writes each element's
// log-density term (Gaussian term plus elementwise ladj) to lacc.
__device__ float* grad_logp(float* ins, float* lacc, const Plan& plan,
                            const float* __restrict__ P,
                            const float* __restrict__ Q,
                            const float* __restrict__ Qt,
                            const float* __restrict__ mu,
                            const float* __restrict__ iv, int ne, int td,
                            int d) {
  const int nst = plan.n_stages;
  const size_t dd = (size_t)d * d;
  if (lacc)
    for (int e = threadIdx.x; e < ne; e += blockDim.x) lacc[e] = 0.f;
  for (int k = 0; k < nst; ++k) {
    const int code = plan.code[k], arg = plan.arg[k];
    const float* in = ins + (size_t)k * td;
    float* out = ins + (size_t)(k + 1) * td;
    if (code == HH) {
      __syncthreads();
      householder_apply(in, out, Qt + (size_t)arg * dd, ne, d);
      __syncthreads();
    } else {
      for (int e = threadIdx.x; e < ne; e += blockDim.x) {
        float el;
        out[e] = stage_fwd(code, in[e], P, arg, d, e % d, &el);
        if (lacc) lacc[e] += el;
      }
    }
  }
  float* cy = ins + (size_t)nst * td;
  for (int e = threadIdx.x; e < ne; e += blockDim.x) {
    const int j = e % d;
    const float ivj = __ldg(iv + j);
    const float dv = cy[e] - __ldg(mu + j);
    if (lacc) lacc[e] += -0.5f * (dv * dv * ivj + ENF_LOG_2PI - logf(ivj));
    cy[e] = -dv * ivj;
  }
  for (int k = nst - 1; k >= 0; --k) {
    const int code = plan.code[k], arg = plan.arg[k];
    float* in = ins + (size_t)k * td;
    if (code == HH) {
      __syncthreads();
      householder_apply(cy, in, Q + (size_t)arg * dd, ne, d);
      __syncthreads();
      cy = in;
    } else {
      for (int e = threadIdx.x; e < ne; e += blockDim.x) {
        float g[4];
        cy[e] = stage_bwd(code, in[e], P, arg, d, e % d, cy[e], 1.f, g);
      }
    }
  }
  return cy;
}

// out[s] = sum over chain s's d elements of lacc, one thread per chain.
__device__ void chain_sums(const float* lacc, float* __restrict__ out, int ns,
                           int d) {
  for (int s = threadIdx.x; s < ns; s += blockDim.x) {
    float sum = 0.f;
    for (int j = 0; j < d; ++j) sum += lacc[s * d + j];
    out[s] = sum;
  }
}

// B6: replaces _fused_leapfrog_impl (ops/pallas/leapfrog.py:157-224). One
// tile of chains per block; see the header for the layout.
__global__ void leapfrog_kernel(const float* __restrict__ q0,
                                const float* __restrict__ p0,
                                float* __restrict__ qo, float* __restrict__ po,
                                float* __restrict__ lp0,
                                float* __restrict__ lpL,
                                const float* __restrict__ eps_ptr,
                                const float* __restrict__ im,
                                const float* __restrict__ mu,
                                const float* __restrict__ iv,
                                const float* __restrict__ P,
                                const float* __restrict__ Q,
                                const float* __restrict__ Qt, Plan plan,
                                long long n, int d, int tile, int num_steps) {
  extern __shared__ float smem[];
  const int td = tile * d;
  float* sq = smem;
  float* sp = sq + td;
  float* lacc = sp + td;
  float* ins = lacc + td;
  const long long s0 = (long long)blockIdx.x * tile;
  const int ns = (int)min((long long)tile, n - s0);
  const int ne = ns * d;
  const float eps = __ldg(eps_ptr);
  const float half_eps = 0.5f * eps;

  for (int e = threadIdx.x; e < ne; e += blockDim.x) {
    const float qv = q0[s0 * d + e];
    sq[e] = qv;
    sp[e] = p0[s0 * d + e];
    ins[e] = qv;
  }
  const float* g = grad_logp(ins, lacc, plan, P, Q, Qt, mu, iv, ne, td, d);
  __syncthreads();
  chain_sums(lacc, lp0 + s0, ns, d);

  // Each thread updates only its own elements of q, p and the gradient, so
  // the updates need no barrier; grad_logp brackets every read of another
  // thread's element (the Householder products) by barriers.
  for (int step = 0; step < num_steps; ++step) {
    const bool last = step == num_steps - 1;
    for (int e = threadIdx.x; e < ne; e += blockDim.x) {
      const float pv = sp[e] + half_eps * g[e];
      const float qv = sq[e] + eps * pv * __ldg(im + e % d);
      sp[e] = pv;
      sq[e] = qv;
      ins[e] = qv;
    }
    if (last) __syncthreads();  // logp_0's sums are read before lacc resets
    g = grad_logp(ins, last ? lacc : nullptr, plan, P, Q, Qt, mu, iv, ne, td,
                  d);
    for (int e = threadIdx.x; e < ne; e += blockDim.x)
      sp[e] += half_eps * g[e];
  }

  __syncthreads();
  chain_sums(lacc, lpL + s0, ns, d);
  for (int e = threadIdx.x; e < ne; e += blockDim.x) {
    qo[s0 * d + e] = sq[e];
    po[s0 * d + e] = sp[e];
  }
}

// C interface: launches on `stream`, does not synchronize, and returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int enf_fused_leapfrog(const float* q0, const float* p0, float* qo,
                                  float* po, float* lp0, float* lpL,
                                  const float* eps, const float* im,
                                  const float* mu, const float* iv,
                                  const float* P, const float* Q,
                                  const float* Qt, const int* codes,
                                  const int* args, int n_stages, long long n,
                                  int d, int tile, int num_steps, int grid,
                                  int block, int smem, void* stream) {
  Plan plan;
  if (make_plan(&plan, codes, args, n_stages) || n <= 0 || d <= 0 ||
      tile <= 0 || num_steps < 0 || (long long)grid * tile < n)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      leapfrog_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  leapfrog_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      q0, p0, qo, po, lp0, lpL, eps, im, mu, iv, P, Q, Qt, plan, n, d, tile,
      num_steps);
  return (int)cudaGetLastError();
}
