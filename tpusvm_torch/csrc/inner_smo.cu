// The blocked SMO solver's whole working-set subproblem in one launch.
//
// Replaces the TPU kernel inner_smo_pallas, single-pair _make_kernel
// (tpusvm/ops/pallas/inner_smo.py), with its semantics exactly: f32 compute;
// I_high/I_low masks over the active set; first-occurrence argmin/argmax;
// wss=1 (first-order) or wss=2 (maximal-gain partner, with the optional
// eta_exclude fallback to first order); the analytic pair update (cap at V,
// then floor at U); two-row f update; SHRINKING of a zero-progress pair's
// i_low instead of ending the subproblem. End reasons: CONVERGED (1),
// NO_WORKING_SET (2) or MAX_ITER (5); -1 only if the iteration guard trips
// (it cannot in exact arithmetic: every iteration updates, shrinks or ends).
//
// What bounds it on an H100: per update it reads the two selected K_BB rows
// (2*q*4 bytes = 16 KB at q=2048) from device memory or L2 (K_BB is 16 MB,
// inside the 50 MB L2), so its byte bound is microseconds per thousand
// updates. What really limits it is the serial chain of block-wide
// reductions: every update waits on 2-3 argmin/argmax reductions across the
// block and on the __syncthreads between phases. iteration_floor_probe
// below measures both floors on the card (the chain alone, the row reads
// alone); chip_smoke.py reports the kernel against them.
//
// Design: one thread block of 1024 threads. alpha, f, y, active and diag
// (5*q floats, 40 KB at q=2048) live in dynamic shared memory; K_BB stays in
// device memory and each iteration reads rows i_h and i_l coalesced. The
// reductions carry (value, index) pairs, warp shuffles then one warp across
// the 32 warp results, with "smaller index wins on equal value": seeded with
// (+-inf, INT_MAX), this returns the first lane equal to the extremum even
// when every lane is +-inf, exactly as jnp.min(jnp.where(v == best, iota, q))
// does. Every thread evaluates the scalar pair update redundantly on the
// same broadcast values, so no extra synchronisation is needed for it.
// Built with -fmad=false: each product and sum rounds as the reference's
// separate f32 operations do, except the f row update, which is two
// explicit FMAs because the reference's compiled update is.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

#include "smo_common.cuh"

namespace {

using tpusvm::gt_first;
using tpusvm::lt_first;

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int RUNNING = 0;
constexpr int CONVERGED = 1;
constexpr int NO_WORKING_SET = 2;
constexpr int MAX_ITER = 5;
constexpr int GUARD_TRIPPED = -1;

struct Scratch {
  float v0[WARPS + 1];
  int i0[WARPS + 1];
  float v1[WARPS + 1];
  int i1[WARPS + 1];
};

// Block-wide argmin of (v0, i0) and argmax of (v1, i1) together; every
// thread returns with the block's results. Two __syncthreads.
__device__ void block_argmin_argmax(float& v0, int& i0, float& v1, int& i1, Scratch& s) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov0 = __shfl_down_sync(0xffffffffu, v0, off);
    const int oi0 = __shfl_down_sync(0xffffffffu, i0, off);
    const float ov1 = __shfl_down_sync(0xffffffffu, v1, off);
    const int oi1 = __shfl_down_sync(0xffffffffu, i1, off);
    if (lt_first(ov0, oi0, v0, i0)) { v0 = ov0; i0 = oi0; }
    if (gt_first(ov1, oi1, v1, i1)) { v1 = ov1; i1 = oi1; }
  }
  if (lane == 0) {
    s.v0[warp] = v0; s.i0[warp] = i0;
    s.v1[warp] = v1; s.i1[warp] = i1;
  }
  __syncthreads();
  if (warp == 0) {
    v0 = s.v0[lane]; i0 = s.i0[lane];
    v1 = s.v1[lane]; i1 = s.i1[lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov0 = __shfl_down_sync(0xffffffffu, v0, off);
      const int oi0 = __shfl_down_sync(0xffffffffu, i0, off);
      const float ov1 = __shfl_down_sync(0xffffffffu, v1, off);
      const int oi1 = __shfl_down_sync(0xffffffffu, i1, off);
      if (lt_first(ov0, oi0, v0, i0)) { v0 = ov0; i0 = oi0; }
      if (gt_first(ov1, oi1, v1, i1)) { v1 = ov1; i1 = oi1; }
    }
    if (lane == 0) {
      s.v0[WARPS] = v0; s.i0[WARPS] = i0;
      s.v1[WARPS] = v1; s.i1[WARPS] = i1;
    }
  }
  __syncthreads();
  v0 = s.v0[WARPS]; i0 = s.i0[WARPS];
  v1 = s.v1[WARPS]; i1 = s.i1[WARPS];
}

__global__ void __launch_bounds__(THREADS)
inner_smo_kernel(const float* __restrict__ K, const float* __restrict__ y_in,
                 const float* __restrict__ a_in, const float* __restrict__ f_in,
                 const float* __restrict__ act_in, float C, float eps, float tau, int q,
                 int max_inner, int wss, int eta_exclude, float* __restrict__ a_out,
                 int* __restrict__ stat) {
  extern __shared__ float smem[];
  float* s_a = smem;
  float* s_f = s_a + q;
  float* s_y = s_f + q;
  float* s_act = s_y + q;
  float* s_diag = s_act + q;
  __shared__ Scratch red0;
  __shared__ Scratch red1;

  const int tid = threadIdx.x;
  for (int i = tid; i < q; i += THREADS) {
    s_a[i] = a_in[i];
    s_f[i] = f_in[i];
    s_y[i] = y_in[i];
    s_act[i] = act_in[i];
    s_diag[i] = K[(size_t)i * q + i];
  }
  __syncthreads();

  const float Cme = C - eps;
  const float two_tau = 2.f * tau;
  int n_upd = 0;
  int progress = 0;
  int reason = RUNNING;
  // every iteration updates (<= max_inner), shrinks one index (<= q) or ends
  const long long guard = (long long)max_inner + q + 2;
  long long it = 0;

  while (reason == RUNNING) {
    if (++it > guard) { reason = GUARD_TRIPPED; break; }

    // ---- first-order picks: b_h/i_h over I_high, b_l/i_l1 over I_low ----
    float bh = INFINITY; int ih = INT_MAX;
    float bl = -INFINITY; int il1 = INT_MAX;
    for (int i = tid; i < q; i += THREADS) {
      const float a = s_a[i];
      const bool act = s_act[i] > 0.5f;
      const bool pos = s_y[i] > 0.f;
      const bool lo = a > eps;
      const bool hi = a < Cme;
      const bool mh = act && ((pos && hi) || (!pos && lo));
      const bool ml = act && ((pos && lo) || (!pos && hi));
      const float vh = mh ? s_f[i] : INFINITY;
      const float vl = ml ? s_f[i] : -INFINITY;
      if (lt_first(vh, i, bh, ih)) { bh = vh; ih = i; }
      if (gt_first(vl, i, bl, il1)) { bl = vl; il1 = i; }
    }
    block_argmin_argmax(bh, ih, bl, il1, red0);

    const bool found = (bh < INFINITY) && (bl > -INFINITY);
    const bool converged = found && (bl <= bh + two_tau);
    const bool proceed = found && !converged;
    ih = min(ih, q - 1);
    il1 = min(il1, q - 1);
    const float* row_h = K + (size_t)ih * q;
    const float K11 = s_diag[ih];

    int il = il1;
    float g = -INFINITY;
    if (wss == 2) {
      // maximal-gain partner among violating I_low members
      float dummy_v = INFINITY; int dummy_i = INT_MAX;
      int il2 = INT_MAX;
      for (int i = tid; i < q; i += THREADS) {
        const float a = s_a[i];
        const bool act = s_act[i] > 0.5f;
        const bool pos = s_y[i] > 0.f;
        const bool lo = a > eps;
        const bool hi = a < Cme;
        const bool ml = act && ((pos && lo) || (!pos && hi));
        const float fi = s_f[i];
        const float eta_raw = (K11 + s_diag[i]) - 2.f * row_h[i];
        const float eta_vec = fmaxf(eta_raw, 1e-12f);
        bool viol = ml && (fi > bh);
        if (eta_exclude) viol = viol && (eta_raw > eps);
        const float diff = fi - bh;
        const float vg = viol ? (diff * diff) / eta_vec : -INFINITY;
        if (gt_first(vg, i, g, il2)) { g = vg; il2 = i; }
      }
      block_argmin_argmax(dummy_v, dummy_i, g, il2, red1);
      if (eta_exclude) il2 = (g > -INFINITY) ? il2 : il1;
      il = min(il2, q - 1);
    }

    const float* row_l = K + (size_t)il * q;
    const float K22 = s_diag[il];
    const float K12 = row_h[il];
    const float y_h = s_y[ih];
    const float y_l = s_y[il];
    const float a_h = s_a[ih];
    const float a_l = s_a[il];
    float b_l_pair = bl;
    if (wss == 2) {
      const float eta_l = fmaxf((K11 + K22) - 2.f * K12, 1e-12f);
      b_l_pair = bh + sqrtf(fmaxf(g, 0.f) * eta_l);
      if (eta_exclude) b_l_pair = (g > -INFINITY) ? b_l_pair : bl;
    }

    const tpusvm::PairStep st =
        tpusvm::pair_step(K11, K22, K12, y_h, y_l, a_h, a_l, bh, b_l_pair, C, eps, proceed);
    const float da_h = st.da_h;
    const float da_l = st.da_l;

    const float ch = da_h * y_h;
    const float cl = da_l * y_l;
    // two fused multiply-adds, as the reference's f + A*row_h + B*row_l
    // compiles (XLA contracts it)
    for (int i = tid; i < q; i += THREADS)
      s_f[i] = __fmaf_rn(cl, row_l[i], __fmaf_rn(ch, row_h[i], s_f[i]));

    const bool ok = st.do_update && !st.stalled;
    n_upd += ok ? 1 : 0;
    progress = progress || ok;
    const bool dead = proceed && (!st.feasible || !st.eta_ok || st.stalled);
    __syncthreads();  // every thread has read a_h, a_l and act before the writes
    if (tid == 0) {
      // i_h == i_l forces eta == 0, hence zero deltas: the order is safe
      s_a[ih] = a_h + da_h;
      s_a[il] = a_l + da_l;
      if (dead) s_act[il] = 0.f;
    }
    __syncthreads();

    reason = !found ? NO_WORKING_SET
                    : converged ? CONVERGED : (n_upd >= max_inner ? MAX_ITER : RUNNING);
  }

  for (int i = tid; i < q; i += THREADS) a_out[i] = s_a[i];
  if (tid == 0) {
    stat[0] = n_upd;
    stat[1] = progress;
    stat[2] = reason;
    stat[3] = (int)it;
  }
}

// Floors for one iteration of inner_smo_kernel, for its bound. mode 0 runs
// only the chain an iteration waits on: the block_argmin_argmax calls (one,
// or two at wss=2), each fed by the previous result so none overlaps, and
// the two barriers around the alpha write. mode 1 only reads two q-float
// rows of K per iteration with one block, as the f update does. Neither
// scans shared memory or computes the pair update, so each is a lower bound
// on the kernel's time per iteration. out holds THREADS floats.
__global__ void __launch_bounds__(THREADS)
iteration_floor_probe(const float* __restrict__ K, int q, int iters, int wss, int mode,
                      float* __restrict__ out) {
  __shared__ Scratch red0;
  __shared__ Scratch red1;
  const int tid = threadIdx.x;
  float acc = 0.f;
  int ih = 0, il = 0;
  for (int it = 0; it < iters; ++it) {
    if (mode == 0) {
      float v0 = (float)((tid * 7 + ih) % 1021);
      int i0 = tid;
      float v1 = (float)((tid * 13 + il) % 1019);
      int i1 = tid;
      block_argmin_argmax(v0, i0, v1, i1, red0);
      ih = i0;
      il = i1;
      if (wss == 2) {
        float dv = INFINITY; int di = INT_MAX;
        float g = (float)((tid * 5 + il) % 1013);
        int ig = tid;
        block_argmin_argmax(dv, di, g, ig, red1);
        il = ig;
      }
      __syncthreads();
      __syncthreads();
    } else {
      const float* rh = K + (size_t)((2 * it) % q) * q;
      const float* rl = K + (size_t)((2 * it + 1) % q) * q;
      for (int i = tid; i < q; i += THREADS) acc += rh[i] + rl[i];
    }
  }
  out[tid] = acc + (float)(ih + il);
}

}  // namespace

extern "C" int tpusvm_inner_smo_floor_probe(const float* K, int q, int iters, int wss, int mode,
                                            float* out, cudaStream_t stream) {
  iteration_floor_probe<<<1, THREADS, 0, stream>>>(K, q, iters, wss, mode, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpusvm_inner_smo_smem_bytes(int q) { return 5 * q * (int)sizeof(float); }

extern "C" int tpusvm_inner_smo(const float* K, const float* y, const float* a, const float* f,
                                const float* act, float C, float eps, float tau, int q,
                                int max_inner, int wss, int eta_exclude, float* a_out, int* stat,
                                cudaStream_t stream) {
  const int smem = tpusvm_inner_smo_smem_bytes(q);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        inner_smo_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  inner_smo_kernel<<<1, THREADS, smem, stream>>>(K, y, a, f, act, C, eps, tau, q, max_inner,
                                                 wss, eta_exclude, a_out, stat);
  return static_cast<int>(cudaGetLastError());
}
