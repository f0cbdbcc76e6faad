// Pieces shared by the inner-subproblem kernels (inner_smo.cu and
// inner_smo_multipair.cu): the first-occurrence (value, index) comparisons
// and the warp's first-occurrence winner by redux.sync, the Hopper bulk
// copy of a row into shared memory on an mbarrier, and the analytic pair
// update. Both sources are built with -fmad=false, so every product and sum
// here rounds as the reference's separate f32 operations do.

#pragma once

#include <climits>
#include <cstdint>
#include <math.h>

namespace tpusvm {

constexpr unsigned FULL_MASK = 0xffffffffu;

// (value, index) orders that make a reduction return the first lane equal
// to the extremum: seeded with (+-inf, INT_MAX), even when every lane is
// +-inf, as jnp.min(jnp.where(v == best, iota, q)) does. They are a total
// order on pairs with distinct indices, so a reduction returns the same
// pair in any combining order.
__device__ __forceinline__ bool lt_first(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}
__device__ __forceinline__ bool gt_first(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

template <bool MIN>
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return MIN ? lt_first(v, i, bv, bi) : gt_first(v, i, bv, bi);
}

// An unsigned key in the order of the float, -0.0 and +0.0 equal (v + 0
// turns -0.0 into +0.0), for the warp's integer min/max instructions.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned b = __float_as_uint(v + 0.f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Whether this lane's candidate (v, i) is the warp's first argmin (MIN) or
// first argmax: one redux.sync for the extreme value's key, one for the
// least index holding it. Indices are distinct but for the (+-inf, INT_MAX)
// seeds of lanes with no candidate, so this is one lane, or every seeded
// lane when the warp has no candidate at all.
template <bool MIN>
__device__ __forceinline__ bool holds_winner(float v, int i) {
  const unsigned k = order_key(v);
  const unsigned b = MIN ? __reduce_min_sync(FULL_MASK, k) : __reduce_max_sync(FULL_MASK, k);
  const int wi = __reduce_min_sync(FULL_MASK, k == b ? i : INT_MAX);
  return k == b && i == wi;
}

// The lane whose candidate is the warp's first argmin (MIN) or first argmax,
// on every lane.
template <bool MIN>
__device__ __forceinline__ int warp_winner(float v, int i) {
  return __ffs(__ballot_sync(FULL_MASK, holds_winner<MIN>(v, i))) - 1;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also expects `bytes` of bulk copies in this phase
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory by the copy engine, completing on bar
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
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

// pair_step with a box of its own for each end: alpha_h in [lo_h, hi_h],
// alpha_l in [lo_l, hi_l] (solver/analytic.py pair_update_box). A seeded
// solve runs its subproblem on the deltas from its float64 alphas, whose
// box is [-alpha0, C - alpha0] member by member.
__device__ __forceinline__ PairStep pair_step_box(float K11, float K22, float K12, float y_h,
                                                  float y_l, float a_h, float a_l, float lo_h,
                                                  float hi_h, float lo_l, float hi_l,
                                                  float b_high, float b_low, float eps,
                                                  bool proceed) {
  const float s = y_h * y_l;
  const float eta = (K11 + K22) - 2.f * K12;
  const float U = s < 0.f ? fmaxf(lo_l, (a_l + lo_h) - a_h) : fmaxf(lo_l, (a_l + a_h) - hi_h);
  const float V = s < 0.f ? fminf(hi_l, (a_l + hi_h) - a_h) : fminf(hi_l, (a_l + a_h) - lo_h);
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
