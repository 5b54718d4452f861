// Stage bodies shared by the fused kernels of elementwise.cu (B1-B3),
// coupling.cu (B4, B5) and leapfrog.cu (B6): the stage codes, and one
// elementwise stage's forward and its hand-derived adjoint at one element
// (B4/B5; B1-B3 and B6 run their own forms on hoisted constants). Parameter
// slot q holds a (d,) vector at P[q*d .. q*d+d). The adjoints follow the
// torch functions _adjoint_* in enflows_tpu_torch/ops/elementwise.py line by
// line.
#pragma once

#include <cuda_runtime.h>

enum { SS = 0, CC = 1, CS = 2, JF = 3, JI = 4, HH = 5 };

#define ENF_LOG2 0.6931471805599453f
#define ENF_LOG_2PI 1.8378770664093453f

// At most this many stages in a fused chain (B1-B3, B6).
#define ENF_MAX_STAGES 32

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
