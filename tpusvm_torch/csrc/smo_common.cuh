// Pieces shared by the inner-subproblem kernels (inner_smo.cu and
// inner_smo_multipair.cu): the first-occurrence (value, index) comparisons
// and the analytic pair update. Both sources are built with -fmad=false, so
// every product and sum here rounds as the reference's separate f32
// operations do.

#pragma once

#include <math.h>

namespace tpusvm {

// (value, index) orders that make a reduction return the first lane equal
// to the extremum: seeded with (+-inf, INT_MAX), even when every lane is
// +-inf, as jnp.min(jnp.where(v == best, iota, q)) does.
__device__ __forceinline__ bool lt_first(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}
__device__ __forceinline__ bool gt_first(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

struct PairStep {
  float da_h;      // change to alpha[i_high] (0 unless do_update)
  float da_l;      // change to alpha[i_low]
  bool feasible;   // U <= V + 1e-12
  bool eta_ok;     // eta > eps
  bool do_update;
  bool stalled;    // do_update but both deltas rounded to exactly 0
};

// The clipped 2-alpha step of tpusvm_torch/solver/analytic.py pair_update:
// box [U, V] from s = y_h*y_l, cap at V first, then floor at U.
__device__ __forceinline__ PairStep pair_step(float K11, float K22, float K12, float y_h,
                                              float y_l, float a_h, float a_l, float b_high,
                                              float b_low, float C, float eps, bool proceed) {
  const float s = y_h * y_l;
  const float eta = (K11 + K22) - 2.f * K12;
  const float U = s < 0.f ? fmaxf(0.f, a_l - a_h) : fmaxf(0.f, (a_l + a_h) - C);
  const float V = s < 0.f ? fminf(C, (C + a_l) - a_h) : fminf(C, a_l + a_h);
  PairStep r;
  r.feasible = U <= V + 1e-12f;
  r.eta_ok = eta > eps;
  r.do_update = proceed && r.feasible && r.eta_ok;
  const float safe_eta = r.eta_ok ? eta : 1.f;
  float a_l_new = a_l + (y_l * (b_high - b_low)) / safe_eta;
  a_l_new = fmaxf(fminf(a_l_new, V), U);
  const float a_h_new = a_h + s * (a_l - a_l_new);
  r.da_h = r.do_update ? a_h_new - a_h : 0.f;
  r.da_l = r.do_update ? a_l_new - a_l : 0.f;
  r.stalled = r.do_update && r.da_h == 0.f && r.da_l == 0.f;
  return r;
}

}  // namespace tpusvm
