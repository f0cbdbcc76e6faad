// The blocked SMO solver's working-set subproblem with p slot pairs per
// iteration, in one launch.
//
// Replaces the TPU kernel inner_smo_pallas(multipair=p > 1),
// _make_multipair_kernel (tpusvm/ops/pallas/inner_smo.py), with its
// semantics exactly. The working set's high half [0, q/2) and low half
// [q/2, q) are cut into p slots of q/(2p) lanes each. Per iteration:
//   - the global first argmin of f over I_high and first argmax over I_low
//     decide the stop (b_low <= b_high + 2 tau) and give the global pair;
//   - slot s pairs the first argmin of its high lanes with the first argmax
//     of its low lanes (an empty slot's "index" is its first lane) and steps
//     only on a locally violating pair, against the iteration-start f
//     (Jacobi across slots); slots never shrink;
//   - the global pair steps after the slots (Gauss-Seidel), unless an
//     applied slot update touched either of its ends; it shrinks its i_low
//     only when every slot idled;
//   - f takes all 2(p+1) row terms into one df, in the order slot 0 h,
//     slot 0 l, ..., global h, global l, then f += df.
// End reasons: CONVERGED (1), NO_WORKING_SET (2, also when every slot and
// the global pair idled), MAX_ITER (5); -1 if the iteration guard trips.
//
// What bounds it on an H100: per iteration it reads at most 2(p+1) K_BB rows
// (2(p+1)*q*4 bytes, 80 KB at q=2048, p=4) from L2, where K_BB (16 MB)
// stays; so, as for the single-pair kernel, the serial chain of reductions
// and barriers per iteration is the limit, not a rate. The gain over
// inner_smo.cu is up to p+1 updates for one chain. multipair_floor_probe
// below measures that chain alone and the row reads alone.
//
// Design: one block of 1024 threads; alpha, f, y, active and diag (5q
// floats) in dynamic shared memory, K_BB rows from L2. The 2p slot halves
// are contiguous lane ranges; each gets 32/(2p) warps of its own, which
// reduce it to (min over I_high, max over I_low) with first-occurrence
// indices, all ranges at once. After one barrier, warp 0 combines them:
// lane r holds range r; a butterfly over the warp gives the global pair on
// every lane; lane s < p takes slot s (its high range, and its low range
// from lane p+s by a shuffle) and computes the slot's pair update; ballots
// give glob_touched and the slot update count; every lane computes the
// global pair update on the same values. A lane gets at most one nonzero
// alpha delta per iteration (slots are disjoint; the global step runs only
// when untouched), so one copy of alpha suffices where the TPU kernel keeps
// a vector and a scalar mirror. Warp 0 writes alpha, the shrink and the
// 2(p+1) row coefficients; after a second barrier every thread applies the
// row terms to its own lanes, the same lanes it scans, so no third barrier
// is needed. Row terms with a zero coefficient are skipped: adding a zero
// product leaves df's value unchanged. Built with -fmad=false; df is formed
// as XLA on the CPU contracts the reference's sum (checked bit for bit
// against interpret mode): slot 0's pair as fma(ch0, row_h0, cl0*row_l0),
// every later term as one fma onto df, then a plain f + df.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

#include "smo_common.cuh"

namespace {

using tpusvm::gt_first;
using tpusvm::lt_first;

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_P = WARPS / 2;  // at least one warp per slot half
constexpr unsigned FULL = 0xffffffffu;
constexpr int RUNNING = 0;
constexpr int CONVERGED = 1;
constexpr int NO_WORKING_SET = 2;
constexpr int MAX_ITER = 5;
constexpr int GUARD_TRIPPED = -1;

struct Partial {
  float vh;
  int ih;
  float vl;
  int il;
};

// Warp-wide first argmin of (vh, ih) and first argmax of (vl, il); every
// lane returns with the result.
__device__ __forceinline__ void warp_argmin_argmax(float& vh, int& ih, float& vl, int& il) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ovh = __shfl_xor_sync(FULL, vh, off);
    const int oih = __shfl_xor_sync(FULL, ih, off);
    const float ovl = __shfl_xor_sync(FULL, vl, off);
    const int oil = __shfl_xor_sync(FULL, il, off);
    if (lt_first(ovh, oih, vh, ih)) { vh = ovh; ih = oih; }
    if (gt_first(ovl, oil, vl, il)) { vl = ovl; il = oil; }
  }
}

// The lanes a thread scans and updates: range r = warp / G of 2p ranges
// (G = 32/(2p) warps each; warps past the last range idle), stepping by the
// range's G*32 threads.
struct Lanes {
  bool live;
  int first;
  int end;
  int stride;
};

__device__ __forceinline__ Lanes my_lanes(int q, int p) {
  const int ranges = 2 * p;
  const int G = WARPS / ranges;
  const int span = q / ranges;
  const int warp = threadIdx.x / 32;
  const int r = warp / G;
  Lanes l;
  l.live = r < ranges;
  l.first = r * span + (warp % G) * 32 + threadIdx.x % 32;
  l.end = (r + 1) * span;
  l.stride = G * 32;
  return l;
}

__global__ void __launch_bounds__(THREADS)
inner_smo_multipair_kernel(const float* __restrict__ K, const float* __restrict__ y_in,
                           const float* __restrict__ a_in, const float* __restrict__ f_in,
                           const float* __restrict__ act_in, float C, float eps, float tau,
                           int q, int max_inner, int p, float* __restrict__ a_out,
                           int* __restrict__ stat) {
  extern __shared__ float smem[];
  float* s_a = smem;
  float* s_f = s_a + q;
  float* s_y = s_f + q;
  float* s_act = s_y + q;
  float* s_diag = s_act + q;
  __shared__ Partial part[WARPS];
  // row coefficients and row indices of this iteration: slots 0..p-1, then
  // the global pair at p
  __shared__ float s_ch[MAX_P + 1];
  __shared__ float s_cl[MAX_P + 1];
  __shared__ int s_ih[MAX_P + 1];
  __shared__ int s_il[MAX_P + 1];
  __shared__ int s_reason;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  for (int i = tid; i < q; i += THREADS) {
    s_a[i] = a_in[i];
    s_f[i] = f_in[i];
    s_y[i] = y_in[i];
    s_act[i] = act_in[i];
    s_diag[i] = K[(size_t)i * q + i];
  }
  __syncthreads();

  const Lanes mine = my_lanes(q, p);
  const int ranges = 2 * p;
  const int G = WARPS / ranges;
  const float Cme = C - eps;
  const float two_tau = 2.f * tau;
  int n_upd = 0;  // kept by thread 0
  int progress = 0;
  int reason = RUNNING;
  // every iteration updates (<= max_inner), shrinks one index (<= q) or ends
  const long long guard = (long long)max_inner + q + 2;
  long long it = 0;

  while (true) {
    if (++it > guard) { reason = GUARD_TRIPPED; break; }

    // ---- every range at once: first argmin over I_high, argmax over I_low
    float vh = INFINITY; int ih = INT_MAX;
    float vl = -INFINITY; int il = INT_MAX;
    if (mine.live) {
      for (int i = mine.first; i < mine.end; i += mine.stride) {
        const float a = s_a[i];
        const bool act = s_act[i] > 0.5f;
        const bool pos = s_y[i] > 0.f;
        const bool lo = a > eps;
        const bool hi = a < Cme;
        const bool mh = act && ((pos && hi) || (!pos && lo));
        const bool ml = act && ((pos && lo) || (!pos && hi));
        const float vhi = mh ? s_f[i] : INFINITY;
        const float vli = ml ? s_f[i] : -INFINITY;
        if (lt_first(vhi, i, vh, ih)) { vh = vhi; ih = i; }
        if (gt_first(vli, i, vl, il)) { vl = vli; il = i; }
      }
    }
    warp_argmin_argmax(vh, ih, vl, il);
    if (lane == 0) part[warp] = Partial{vh, ih, vl, il};
    __syncthreads();

    if (warp == 0) {
      // lane r < 2p: range r's result
      float rh = INFINITY; int rih = INT_MAX;
      float rl = -INFINITY; int ril = INT_MAX;
      if (lane < ranges) {
        for (int g = 0; g < G; ++g) {
          const Partial pp = part[lane * G + g];
          if (lt_first(pp.vh, pp.ih, rh, rih)) { rh = pp.vh; rih = pp.ih; }
          if (gt_first(pp.vl, pp.il, rl, ril)) { rl = pp.vl; ril = pp.il; }
        }
      }
      // slot s = lane < p: high lanes from range s, low lanes from range p+s
      const float bl_s = __shfl_sync(FULL, rl, (lane + p) & 31);
      const int il_s = __shfl_sync(FULL, ril, (lane + p) & 31);
      const float bh_s = rh;
      const int ih_s = rih;
      // the global pair, on every lane
      float gh = rh; int gih = rih;
      float gl = rl; int gil = ril;
      warp_argmin_argmax(gh, gih, gl, gil);
      gih = min(gih, q - 1);
      gil = min(gil, q - 1);
      const bool found = (gh < INFINITY) && (gl > -INFINITY);
      const bool converged = found && (gl <= gh + two_tau);
      const bool proceed = found && !converged;

      bool slot_ok = false;
      bool touched = false;
      tpusvm::PairStep st{};
      float a_h = 0.f, a_l = 0.f, y_h = 0.f, y_l = 0.f;
      if (lane < p) {
        const bool ok_s = (bh_s < INFINITY) && (bl_s > -INFINITY) && (bl_s > bh_s + two_tau);
        a_h = s_a[ih_s];
        a_l = s_a[il_s];
        y_h = s_y[ih_s];
        y_l = s_y[il_s];
        st = tpusvm::pair_step(s_diag[ih_s], s_diag[il_s], K[(size_t)ih_s * q + il_s], y_h,
                               y_l, a_h, a_l, bh_s, bl_s, C, eps, proceed && ok_s);
        slot_ok = st.do_update && !st.stalled;
        touched = slot_ok && (ih_s == gih || il_s == gih || ih_s == gil || il_s == gil);
      }
      const int n_slot = __popc(__ballot_sync(FULL, slot_ok));
      const bool glob_go = proceed && !__any_sync(FULL, touched);
      // untouched ends hold their iteration-start alphas; on a touched end
      // the step is off and its deltas are zero
      const float a_hg = s_a[gih];
      const float a_lg = s_a[gil];
      const float y_hg = s_y[gih];
      const float y_lg = s_y[gil];
      const tpusvm::PairStep g =
          tpusvm::pair_step(s_diag[gih], s_diag[gil], K[(size_t)gih * q + gil], y_hg, y_lg,
                            a_hg, a_lg, gh, gl, C, eps, glob_go);
      const bool okg = g.do_update && !g.stalled;
      const bool deadg =
          glob_go && n_slot == 0 && (!g.feasible || !g.eta_ok || g.stalled);
      const int n_ok = n_slot + (okg ? 1 : 0);
      __syncwarp();  // every lane has read alpha before the writes
      if (lane < p) {
        if (slot_ok) {
          s_a[ih_s] = a_h + st.da_h;
          s_a[il_s] = a_l + st.da_l;
        }
        s_ch[lane] = st.da_h * y_h;
        s_cl[lane] = st.da_l * y_l;
        s_ih[lane] = ih_s;
        s_il[lane] = il_s;
      }
      if (lane == 0) {
        if (okg) {
          s_a[gih] = a_hg + g.da_h;
          s_a[gil] = a_lg + g.da_l;
        }
        if (deadg) s_act[gil] = 0.f;
        s_ch[p] = g.da_h * y_hg;
        s_cl[p] = g.da_l * y_lg;
        s_ih[p] = gih;
        s_il[p] = gil;
        n_upd += n_ok;
        progress = progress || n_ok > 0;
        const bool idle = proceed && n_ok == 0 && !deadg;
        s_reason = (!found || idle) ? NO_WORKING_SET
                   : converged      ? CONVERGED
                   : (n_upd >= max_inner ? MAX_ITER : RUNNING);
      }
    }
    __syncthreads();

    // ---- f += df on this thread's own lanes ----
    if (mine.live) {
      for (int i = mine.first; i < mine.end; i += mine.stride) {
        float df = 0.f;
        if (s_cl[0] != 0.f) df = s_cl[0] * K[(size_t)s_il[0] * q + i];
        if (s_ch[0] != 0.f) df = __fmaf_rn(s_ch[0], K[(size_t)s_ih[0] * q + i], df);
        for (int k = 1; k <= p; ++k) {
          if (s_ch[k] != 0.f) df = __fmaf_rn(s_ch[k], K[(size_t)s_ih[k] * q + i], df);
          if (s_cl[k] != 0.f) df = __fmaf_rn(s_cl[k], K[(size_t)s_il[k] * q + i], df);
        }
        s_f[i] = s_f[i] + df;
      }
    }
    reason = s_reason;
    if (reason != RUNNING) break;
  }

  __syncthreads();
  for (int i = tid; i < q; i += THREADS) a_out[i] = s_a[i];
  if (tid == 0) {
    stat[0] = n_upd;
    stat[1] = progress;
    stat[2] = reason;
    stat[3] = (int)it;
  }
}

// Floors for one iteration of inner_smo_multipair_kernel, for its bound.
// mode 0 runs only the chain an iteration waits on: every warp's reduction,
// the barrier, warp 0's combine of the range results and its butterfly (each
// fed by the previous iteration's result so none overlaps), and the second
// barrier. mode 1 only reads 2(p+1) q-float rows of K per iteration with one
// block, as the f update does when every slot and the global pair update.
// Neither scans shared memory or computes a pair update, so each is a lower
// bound on the kernel's time per iteration. out holds THREADS floats.
__global__ void __launch_bounds__(THREADS)
multipair_floor_probe(const float* __restrict__ K, int q, int p, int iters, int mode,
                      float* __restrict__ out) {
  __shared__ Partial part[WARPS];
  __shared__ int s_seed;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int ranges = 2 * p;
  const int G = WARPS / ranges;
  const Lanes mine = my_lanes(q, p);
  if (tid == 0) s_seed = 0;
  __syncthreads();
  float acc = 0.f;
  for (int it = 0; it < iters; ++it) {
    if (mode == 0) {
      const int seed = s_seed;
      float vh = (float)((tid * 7 + seed) % 1021); int ih = tid;
      float vl = (float)((tid * 13 + seed) % 1019); int il = tid;
      warp_argmin_argmax(vh, ih, vl, il);
      if (lane == 0) part[warp] = Partial{vh, ih, vl, il};
      __syncthreads();
      if (warp == 0) {
        float rh = INFINITY; int rih = INT_MAX;
        float rl = -INFINITY; int ril = INT_MAX;
        if (lane < ranges) {
          for (int g = 0; g < G; ++g) {
            const Partial pp = part[lane * G + g];
            if (lt_first(pp.vh, pp.ih, rh, rih)) { rh = pp.vh; rih = pp.ih; }
            if (gt_first(pp.vl, pp.il, rl, ril)) { rl = pp.vl; ril = pp.il; }
          }
        }
        warp_argmin_argmax(rh, rih, rl, ril);
        if (lane == 0) s_seed = rih + ril;
      }
      __syncthreads();
    } else if (mine.live) {
      for (int i = mine.first; i < mine.end; i += mine.stride)
        for (int k = 0; k < 2 * (p + 1); ++k) acc += K[(size_t)((it * 2 * (p + 1) + k) % q) * q + i];
    }
  }
  out[tid] = acc + (float)s_seed;
}

}  // namespace

extern "C" int tpusvm_inner_smo_multipair_floor_probe(const float* K, int q, int p, int iters,
                                                      int mode, float* out,
                                                      cudaStream_t stream) {
  multipair_floor_probe<<<1, THREADS, 0, stream>>>(K, q, p, iters, mode, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpusvm_inner_smo_multipair(const float* K, const float* y, const float* a,
                                          const float* f, const float* act, float C, float eps,
                                          float tau, int q, int max_inner, int p, float* a_out,
                                          int* stat, cudaStream_t stream) {
  if (p < 2 || p > MAX_P || q % (2 * p)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 5 * q * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        inner_smo_multipair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  inner_smo_multipair_kernel<<<1, THREADS, smem, stream>>>(K, y, a, f, act, C, eps, tau, q,
                                                           max_inner, p, a_out, stat);
  return static_cast<int>(cudaGetLastError());
}
