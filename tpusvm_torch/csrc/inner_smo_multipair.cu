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
// What bounds it on an H100: per iteration it reads up to 2(p+1) K_BB rows
// (2(p+1)*q*4 bytes, 80 KB at q=2048, p=4) from L2, where K_BB (16 MB)
// stays, into one SM, and waits on a serial chain of reductions and two
// barriers. The byte bound is microseconds per thousand updates; latency,
// one SM's share of L2 and its instruction issue are the limits.
// multipair_floor_probe below measures the chain alone and one iteration's
// row reads alone, issued and applied as the kernel does.
//
// Design: one block of 1024 threads. alpha, f, y and diag (4q floats) and
// each lane's I_high/I_low membership (q bytes, recomputed only for the
// lanes whose alpha or active flag changes) live in dynamic shared memory,
// followed by a row stage. The 2p slot halves are contiguous lane ranges;
// each gets 32/(2p) warps of its own, whose threads own two neighbouring
// lanes at a time (float2) and reduce the range to (value, index) of the
// first argmin over I_high and first argmax over I_low (redux.sync), all
// ranges at once. After one barrier, warp 0 combines them: lane r holds
// range r; a warp reduction gives the global pair on every lane; lane s < p
// takes slot s (its high range, and its low range from lane p+s by a
// shuffle). Lanes 0..p then read the p+1 pairs' alpha, y and diag from
// shared memory and their K12 from L2 in one round trip, and compute all
// p+1 pair steps at once (lane p the global one, as if it stepped, masked
// when an applied slot update touched its ends). A lane gets at most one
// nonzero alpha delta per iteration (slots are disjoint; the global step
// runs only when untouched), so one copy of alpha suffices where the TPU
// kernel keeps a vector and a scalar mirror. Warp 0 writes alpha, the
// memberships, the shrink and the 2(p+1) row coefficients. Meanwhile warp
// 1 repeats the combine and starts a Hopper bulk copy (cp.async.bulk, on
// an mbarrier) of the row of every pair that can step into the stage, so
// the copies overlap warp 0's K12 round trip, pair steps and writes and the
// second barrier (the rows of a pair that ends up idle are copied for
// nothing). After that barrier every thread waits on the mbarrier and
// applies the terms from the stage to its own lanes, the same lanes it
// scans, so no third barrier is needed. Where 2(p+1) rows of q floats do
// not fit beside the working set, the stage holds them a column chunk at a
// time. Built with -fmad=false; df is formed as XLA on the CPU contracts
// the reference's sum (checked bit for bit against interpret mode): slot
// 0's pair as fma(ch0, row_h0, cl0*row_l0), every later term as one fma
// onto df, a zero-coefficient term skipped, then a plain f + df.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

#include "smo_common.cuh"

namespace {

using tpusvm::FULL_MASK;
using tpusvm::gt_first;
using tpusvm::lt_first;
using tpusvm::warp_winner;

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_P = WARPS / 2;  // at least one warp per slot half
constexpr int MAX_T = 2 * (MAX_P + 1);
constexpr int RUNNING = 0;
constexpr int CONVERGED = 1;
constexpr int NO_WORKING_SET = 2;
constexpr int MAX_ITER = 5;
constexpr int GUARD_TRIPPED = -1;

// Dynamic shared memory: alpha, f, y and diag (4q floats), each lane's
// I_high/I_low membership (q bytes), then the row stage at a 128-byte
// boundary: 2(p+1) rows of cw floats, cw = q unless that does not fit.
__host__ __device__ int stage_offset(int q) { return (17 * q + 127) / 128 * 128; }

// The lanes a thread scans and updates, two neighbours at a time (float2):
// range r = warp / G of 2p ranges (G = 32/(2p) warps each; warps past the
// last range idle), pairs of lanes stepping by the range's 2*G*32 lanes.
// Every range has an even number of lanes (check: q % 128 == 0).
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
  l.first = r * span + 2 * ((warp % G) * 32 + threadIdx.x % 32);
  l.end = (r + 1) * span;
  l.stride = 2 * G * 32;
  return l;
}

// The rows one lane of the copying warp copies: lane s < p its slot's two,
// lane p the global pair's, when that pair can step; K_BB row and stage
// slot of each.
struct Rows {
  bool copy;
  int rh, rl;
  int th, tl;
};

// One warp: copy columns [c*cw, c*cw + cw) of the lanes' rows into the
// stage, completing on bar (one arrival, expecting all their bytes).
__device__ __forceinline__ void issue_chunk(const Rows& rw, const float* __restrict__ K, int q,
                                            int cw, int c, float* stage, uint32_t bar) {
  const int c0 = c * cw;
  const int bytes = min(cw, q - c0) * (int)sizeof(float);
  const int total = __reduce_add_sync(FULL_MASK, rw.copy ? 2 * bytes : 0);
  if (threadIdx.x % 32 == 0) tpusvm::mbar_arrive_expect(bar, total);
  __syncwarp();
  if (rw.copy) {
    tpusvm::bulk_copy(stage + rw.th * cw, K + (size_t)rw.rh * q + c0, bytes, bar);
    tpusvm::bulk_copy(stage + rw.tl * cw, K + (size_t)rw.rl * q + c0, bytes, bar);
  }
}

// f[i] += df on this thread's lanes in chunk c, df from the staged rows in
// term order: coef[0]*row (or 0), then one FMA per later term, a zero
// coefficient skipped (the coefficients are the block's, so the branch is
// uniform). Every row with a nonzero coefficient was copied.
__device__ __forceinline__ void apply_chunk(const Lanes& mine, const float* coef, int nt, int q,
                                            int cw, int c, const float* stage, float* s_f) {
  const int c0 = c * cw;
  const int c1 = min(q, c0 + cw);
  for (int i = mine.first; i < mine.end; i += mine.stride) {
    if (i < c0 || i >= c1) continue;
    const float* col = stage + (i - c0);
    float2 df = make_float2(0.f, 0.f);
    const float k0 = coef[0];
    if (k0 != 0.f) {
      const float2 v = *reinterpret_cast<const float2*>(col);
      df = make_float2(k0 * v.x, k0 * v.y);
    }
#pragma unroll 4
    for (int t = 1; t < nt; ++t) {
      const float k = coef[t];
      if (k != 0.f) {
        const float2 v = *reinterpret_cast<const float2*>(col + t * cw);
        df = make_float2(__fmaf_rn(k, v.x, df.x), __fmaf_rn(k, v.y, df.y));
      }
    }
    float2* f = reinterpret_cast<float2*>(s_f + i);
    const float2 f0 = *f;
    *f = make_float2(f0.x + df.x, f0.y + df.y);
  }
}

// A lane's membership of I_high (bit 0) and I_low (bit 1). It changes only
// where alpha or the active mask does, so the kernel keeps it per lane and
// recomputes it for the lanes it writes.
__device__ __forceinline__ unsigned char membership(float a, float y, bool act, float eps,
                                                    float Cme) {
  const bool pos = y > 0.f;
  const bool lo = a > eps;
  const bool hi = a < Cme;
  const bool mh = act && ((pos && hi) || (!pos && lo));
  const bool ml = act && ((pos && lo) || (!pos && hi));
  return (unsigned char)(mh | (ml << 1));
}

// One lane's candidates for the range's first argmin over I_high (vh, ih)
// and first argmax over I_low (vl, il).
__device__ __forceinline__ void scan_lane(int i, unsigned char mem, float f, float& vh, int& ih,
                                          float& vl, int& il) {
  const float vhi = (mem & 1) ? f : INFINITY;
  const float vli = (mem & 2) ? f : -INFINITY;
  if (lt_first(vhi, i, vh, ih)) { vh = vhi; ih = i; }
  if (gt_first(vli, i, vl, il)) { vl = vli; il = i; }
}

// A reduction's candidate: a lane's value and index.
struct Cand {
  float v;
  int i;
};

template <bool MIN>
__device__ __forceinline__ void take(Cand& x, const Cand& o) {
  if (tpusvm::better<MIN>(o.v, o.i, x.v, x.i)) x = o;
}

// warp-wide first argmin (MIN) or argmax of x, on every lane
template <bool MIN>
__device__ __forceinline__ Cand warp_cand(const Cand& x) {
  const int src = warp_winner<MIN>(x.v, x.i);
  return Cand{__shfl_sync(FULL_MASK, x.v, src), __shfl_sync(FULL_MASK, x.i, src)};
}

// What warps 0 and 1 both work out after the first barrier: each range's
// result (lane r < 2p), slot s's pair on lane s < p, the global pair on
// every lane, and whether the subproblem proceeds.
struct Combined {
  Cand sh, sl, gh, gl;
  int gih, gil;
  bool found, converged, proceed, ok_s;
};

__device__ __forceinline__ Combined combine(const Cand* part_h, const Cand* part_l, int p, int q,
                                            float two_tau) {
  const int lane = threadIdx.x % 32;
  const int ranges = 2 * p;
  const int G = WARPS / ranges;
  Cand rh{INFINITY, INT_MAX};
  Cand rl{-INFINITY, INT_MAX};
  if (lane < ranges) {
    for (int g = 0; g < G; ++g) {
      take<true>(rh, part_h[lane * G + g]);
      take<false>(rl, part_l[lane * G + g]);
    }
  }
  // slot s = lane < p: high lanes from range s, low lanes from range p+s
  const int from = (lane + p) & 31;
  Combined m;
  m.sh = rh;
  m.sl = Cand{__shfl_sync(FULL_MASK, rl.v, from), __shfl_sync(FULL_MASK, rl.i, from)};
  m.gh = warp_cand<true>(rh);
  m.gl = warp_cand<false>(rl);
  m.gih = min(m.gh.i, q - 1);
  m.gil = min(m.gl.i, q - 1);
  m.found = (m.gh.v < INFINITY) && (m.gl.v > -INFINITY);
  m.converged = m.found && (m.gl.v <= m.gh.v + two_tau);
  m.proceed = m.found && !m.converged;
  m.ok_s = (m.sh.v < INFINITY) && (m.sl.v > -INFINITY) && (m.sl.v > m.sh.v + two_tau);
  return m;
}

__global__ void __launch_bounds__(THREADS)
inner_smo_multipair_kernel(const float* __restrict__ K, const float* __restrict__ y_in,
                           const float* __restrict__ a_in, const float* __restrict__ f_in,
                           const float* __restrict__ act_in, float C, float eps, float tau,
                           int q, int max_inner, int p, int cw, float* __restrict__ a_out,
                           int* __restrict__ stat) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_a = reinterpret_cast<float*>(smem);
  float* s_f = s_a + q;
  float* s_y = s_f + q;
  float* s_diag = s_y + q;
  unsigned char* s_mem = reinterpret_cast<unsigned char*>(s_diag + q);
  float* stage = reinterpret_cast<float*>(smem + stage_offset(q));
  __shared__ Cand part_h[WARPS];
  __shared__ Cand part_l[WARPS];
  // this iteration's row coefficients in df order: slot 0 l, slot 0 h,
  // then h, l of slots 1..p-1 and of the global pair
  __shared__ float s_coef[MAX_T];
  __shared__ __align__(8) unsigned long long s_bar;
  __shared__ int s_reason;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const uint32_t bar = tpusvm::smem_u32(&s_bar);
  const float Cme = C - eps;
  const float two_tau = 2.f * tau;
  for (int i = tid; i < q; i += THREADS) {
    s_a[i] = a_in[i];
    s_f[i] = f_in[i];
    s_y[i] = y_in[i];
    s_mem[i] = membership(a_in[i], y_in[i], act_in[i] > 0.5f, eps, Cme);
    s_diag[i] = K[(size_t)i * q + i];
  }
  if (tid == 0) tpusvm::mbar_init(bar);
  __syncthreads();

  const Lanes mine = my_lanes(q, p);
  const int nt = 2 * (p + 1);
  const int chunks = (q + cw - 1) / cw;
  uint32_t phase = 0;
  Rows rw{false, 0, 0, 0, 0};  // warp 1's, lanes 0..p
  int n_upd = 0;  // kept by thread 0
  int progress = 0;
  int reason = RUNNING;
  // every iteration updates (<= max_inner), shrinks one index (<= q) or ends
  const long long guard = (long long)max_inner + q + 2;
  long long it = 0;

  while (true) {
    if (++it > guard) { reason = GUARD_TRIPPED; break; }

    // ---- every range at once: first argmin over I_high, argmax over I_low
    float vh = INFINITY, vl = -INFINITY;
    int ih = INT_MAX, il = INT_MAX;
    if (mine.live) {
      for (int i = mine.first; i < mine.end; i += mine.stride) {
        const float2 f = *reinterpret_cast<const float2*>(s_f + i);
        const uchar2 mem = *reinterpret_cast<const uchar2*>(s_mem + i);
        scan_lane(i, mem.x, f.x, vh, ih, vl, il);
        scan_lane(i + 1, mem.y, f.y, vh, ih, vl, il);
      }
    }
    // each warp's winners, written by the lanes that hold them (seeded
    // lanes of a warp with no candidate all write the same seed)
    if (tpusvm::holds_winner<true>(vh, ih)) part_h[warp] = Cand{vh, ih};
    if (tpusvm::holds_winner<false>(vl, il)) part_l[warp] = Cand{vl, il};
    __syncthreads();

    if (warp == 1) {
      // the rows of every pair that can step go out now, so the copies
      // overlap warp 0's K12 round trip, pair steps and writes, and the
      // barrier; a pair that ends up idle has copied rows that go unused
      const Combined m = combine(part_h, part_l, p, q, two_tau);
      if (lane < p) {
        rw = Rows{m.proceed && m.ok_s, m.sh.i, m.sl.i, lane == 0 ? 1 : 2 * lane,
                  lane == 0 ? 0 : 2 * lane + 1};
      } else {
        rw = Rows{lane == p && m.proceed, m.gih, m.gil, 2 * p, 2 * p + 1};
      }
      issue_chunk(rw, K, q, cw, 0, stage, bar);
    } else if (warp == 0) {
      const Combined m = combine(part_h, part_l, p, q, two_tau);
      // every pair's scalars and K12 in one round trip, and every pair step
      // at once: slot s on lane s; the global pair on lane p, as if it
      // stepped, masked below when an applied slot update touched it
      // (alpha is still the iteration's start here)
      const bool slot = lane < p;
      const float vh_ = slot ? m.sh.v : m.gh.v;
      const float vl_ = slot ? m.sl.v : m.gl.v;
      const int jh = lane <= p ? (slot ? m.sh.i : m.gih) : 0;
      const int jl = lane <= p ? (slot ? m.sl.i : m.gil) : 0;
      const float a_h = s_a[jh], y_h = s_y[jh], d_h = s_diag[jh];
      const float a_l = s_a[jl], y_l = s_y[jl], d_l = s_diag[jl];
      const float k12 = lane <= p ? K[(size_t)jh * q + jl] : 0.f;
      const tpusvm::PairStep st =
          tpusvm::pair_step(d_h, d_l, k12, y_h, y_l, a_h, a_l, vh_, vl_, C, eps,
                            slot ? m.proceed && m.ok_s : m.proceed);
      const bool slot_ok = slot && st.do_update && !st.stalled;
      const bool touched = slot_ok && (jh == m.gih || jl == m.gih || jh == m.gil || jl == m.gil);
      const int n_slot = __popc(__ballot_sync(FULL_MASK, slot_ok));
      const bool glob_go = m.proceed && !__any_sync(FULL_MASK, touched);
      // lane p: the global step with proceed = glob_go; untouched ends hold
      // their iteration-start alphas
      const bool g_stalled = glob_go && st.stalled;
      const bool okg = glob_go && st.do_update && !g_stalled;
      const bool deadg = glob_go && n_slot == 0 && (!st.feasible || !st.eta_ok || g_stalled);
      const float da_h = slot || glob_go ? st.da_h : 0.f;
      const float da_l = slot || glob_go ? st.da_l : 0.f;
      if (lane <= p) {
        s_coef[slot ? (lane == 0 ? 1 : 2 * lane) : 2 * p] = da_h * y_h;
        s_coef[slot ? (lane == 0 ? 0 : 2 * lane + 1) : 2 * p + 1] = da_l * y_l;
        // the ends of a pair that steps are active members
        if (slot_ok || (!slot && okg)) {
          s_a[jh] = a_h + da_h;
          s_a[jl] = a_l + da_l;
          s_mem[jh] = membership(a_h + da_h, y_h, true, eps, Cme);
          s_mem[jl] = membership(a_l + da_l, y_l, true, eps, Cme);
        }
        if (!slot && deadg) s_mem[jl] = 0;  // shrunk: in neither set
      }
      const bool okg_p = __shfl_sync(FULL_MASK, okg, p);
      const bool deadg_p = __shfl_sync(FULL_MASK, deadg, p);
      if (lane == 0) {
        const int n_ok = n_slot + (okg_p ? 1 : 0);
        n_upd += n_ok;
        progress = progress || n_ok > 0;
        const bool idle = m.proceed && n_ok == 0 && !deadg_p;
        s_reason = (!m.found || idle) ? NO_WORKING_SET
                   : m.converged      ? CONVERGED
                   : (n_upd >= max_inner ? MAX_ITER : RUNNING);
      }
    }
    __syncthreads();

    // ---- f += df on this thread's own lanes, a stage of columns at a time
    for (int c = 0; c < chunks; ++c) {
      if (c > 0) {
        __syncthreads();  // every thread is done with the last chunk's stage
        if (warp == 1) issue_chunk(rw, K, q, cw, c, stage, bar);
      }
      tpusvm::mbar_wait(bar, phase);
      phase ^= 1;
      if (mine.live) apply_chunk(mine, s_coef, nt, q, cw, c, stage, s_f);
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
// the barrier, warp 0's combine of the range results and its global
// reduction (each fed by the previous iteration's result so none overlaps),
// and the second barrier. mode 1 runs only the f update's row reads: one
// warp copies all 2(p+1) rows into the stage at once and every thread
// applies them (every coefficient nonzero, as when every slot and the
// global pair update), by the kernel's own issue_chunk and apply_chunk;
// each iteration's rows wait on the last one's sums. Neither scans the
// working set or computes a pair update, so each is a lower bound on the
// kernel's time per iteration. out holds THREADS floats; mode 1 takes the
// kernel's dynamic shared memory.
__global__ void __launch_bounds__(THREADS)
multipair_floor_probe(const float* __restrict__ K, int q, int p, int cw, int iters, int mode,
                      float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_f = reinterpret_cast<float*>(smem);
  float* stage = reinterpret_cast<float*>(smem + stage_offset(q));
  __shared__ Cand part_h[WARPS];
  __shared__ Cand part_l[WARPS];
  __shared__ float s_coef[MAX_T];
  __shared__ __align__(8) unsigned long long s_bar;
  __shared__ int s_seed;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int nt = 2 * (p + 1);
  const int chunks = (q + cw - 1) / cw;
  const Lanes mine = my_lanes(q, p);
  const uint32_t bar = tpusvm::smem_u32(&s_bar);
  uint32_t phase = 0;
  if (tid == 0) {
    s_seed = 0;
    tpusvm::mbar_init(bar);
  }
  if (tid < MAX_T) s_coef[tid] = 1.f;
  if (mode == 1)
    for (int i = tid; i < q; i += THREADS) s_f[i] = 0.f;
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    if (mode == 0) {
      const int seed = s_seed;
      const float vh = (float)((tid * 7 + seed) % 1021);
      const float vl = (float)((tid * 13 + seed) % 1019);
      if (tpusvm::holds_winner<true>(vh, tid)) part_h[warp] = Cand{vh, tid};
      if (tpusvm::holds_winner<false>(vl, tid)) part_l[warp] = Cand{vl, tid};
      __syncthreads();
      if (warp == 0) {
        const Combined m = combine(part_h, part_l, p, q, 0.f);
        if (lane == 0) s_seed = m.gh.i + m.gl.i;
      }
      __syncthreads();
    } else {
      Rows rw{false, 0, 0, 0, 0};
      if (warp == 1 && lane <= p) {
        // the rows wait on the last iteration's sums, as the kernel's do
        const int dep = (int)(s_f[0] * 0.f);
        const int base = it * nt + 2 * lane + dep;
        rw = Rows{true, base % q, (base + 1) % q, 2 * lane, 2 * lane + 1};
      }
      for (int c = 0; c < chunks; ++c) {
        if (warp == 1) issue_chunk(rw, K, q, cw, c, stage, bar);
        tpusvm::mbar_wait(bar, phase);
        phase ^= 1;
        if (mine.live) apply_chunk(mine, s_coef, nt, q, cw, c, stage, s_f);
        __syncthreads();
      }
    }
  }
  __syncthreads();
  out[tid] = (mode == 1 ? s_f[tid % q] : 0.f) + (float)s_seed;
}

// The stage's column width for (q, p): all of q where 2(p+1) rows fit in
// the shared memory a block may use, else the widest multiple of 32 that
// does; 0 if not even that fits.
int stage_columns(int q, int p, int static_bytes, int* smem) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  const int nt = 2 * (p + 1);
  const int room = optin - static_bytes - stage_offset(q);
  const int cw = min(q, room / (nt * (int)sizeof(float)) / 32 * 32);
  *smem = stage_offset(q) + nt * cw * (int)sizeof(float);
  return cw;
}

template <typename Kernel>
int prepare(Kernel kernel, int q, int p, int* cw, int* smem) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *cw = stage_columns(q, p, (int)attr.sharedSizeBytes, smem);
  if (*cw < 32) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  return static_cast<int>(err);
}

bool bad_shape(int q, int p) { return p < 2 || p > MAX_P || q % (2 * p) || q % 128; }

}  // namespace

extern "C" int tpusvm_inner_smo_multipair_floor_probe(const float* K, int q, int p, int iters,
                                                      int mode, float* out,
                                                      cudaStream_t stream) {
  if (bad_shape(q, p)) return static_cast<int>(cudaErrorInvalidValue);
  int cw = 0, smem = 0;
  const int rc = prepare(multipair_floor_probe, q, p, &cw, &smem);
  if (rc) return rc;
  multipair_floor_probe<<<1, THREADS, smem, stream>>>(K, q, p, cw, iters, mode, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpusvm_inner_smo_multipair(const float* K, const float* y, const float* a,
                                          const float* f, const float* act, float C, float eps,
                                          float tau, int q, int max_inner, int p, float* a_out,
                                          int* stat, cudaStream_t stream) {
  if (bad_shape(q, p)) return static_cast<int>(cudaErrorInvalidValue);
  int cw = 0, smem = 0;
  const int rc = prepare(inner_smo_multipair_kernel, q, p, &cw, &smem);
  if (rc) return rc;
  inner_smo_multipair_kernel<<<1, THREADS, smem, stream>>>(K, y, a, f, act, C, eps, tau, q,
                                                           max_inner, p, cw, a_out, stat);
  return static_cast<int>(cudaGetLastError());
}
