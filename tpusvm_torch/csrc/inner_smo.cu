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
// (2*q*4 bytes = 16 KB at q=2048) from L2 (K_BB is 16 MB, inside the 50 MB
// L2), so its byte bound is microseconds per thousand updates. What really
// limits it is the serial chain per iteration: one block-wide reduction
// (two at wss=2), each a barrier, and the L2 round trips for row_h and
// row_l. iteration_floor_probe below measures the chain alone and the row
// reads alone; chip_smoke.py reports the kernel against them.
//
// Design: one thread block of 512 threads, each owning the lanes
// i = tid + j*512. A thread keeps its first four lanes' alpha, f, y,
// active, diag and row_h value in registers (q <= 2048 lives in registers
// whole) and any further lanes in shared memory that only it touches, so
// no barrier guards the working set: the owner of i_h and i_l writes their
// alphas and the shrink itself. The reductions carry (value, index) pairs
// with "smaller index wins on equal value" (seeded with (+-inf, INT_MAX),
// this returns the first lane equal to the extremum even when every lane
// is +-inf, exactly as jnp.min(jnp.where(v == best, iota, q)) does), and
// with the winner's alpha, y and diag, and at wss=2 its row_h value, so
// K11, K22, K12 and the pair's scalars need no read after the reduction.
// Each block reduction takes one barrier: warps reduce with redux.sync
// (tpusvm::holds_winner; the winning lane writes, no ballot) into one of
// two buffers,
// used in turn, and every warp finds the block's winner among the 16
// partials itself. row_h is loaded into registers right after the first
// reduction, for the gain scan and the f update; row_l right after the
// second (with K12, at wss=1, in the same round trip). Every thread
// evaluates the scalar pair update redundantly on the same values. Built
// with -fmad=false: each product and sum rounds as the reference's separate
// f32 operations do, except the f row update, which is two explicit FMAs
// because the reference's compiled update is.
//
// The fleet's problem-axis launch (tpusvm_inner_smo_batched): B working sets
// of one q, stacked, one block each, <<<B, THREADS>>>. Block b reads only
// lane b's K_BB, y, alpha, f and active slices and its own C, and writes only
// its a_out slice and its four stat entries; its arithmetic is the solo
// kernel's, so a lane's outputs equal a solo launch on its operands bit for
// bit. The caller stacks only the lanes that run a subproblem this round.
//
// Boxed lanes (the BOX instantiations): a seeded solve starts from float64
// alphas that float32 cannot hold, so its lanes run on the DELTAS from them:
// alpha in is 0, and each member carries its own box [lo, hi] = [-alpha0,
// C - alpha0] (rounded once to float32). The masks test a > lo + eps and
// a < hi - eps, and the pair step clips to the two members' boxes
// (tpusvm::pair_step_box), so a member within a float32 ulp of C is still
// told apart from C, and a late step of 1e-7 still moves its delta. A lane
// not boxed (boxed[b] == 0 in a batched launch) keeps the plain arithmetic
// bit for bit.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

#include "smo_common.cuh"

namespace {

using tpusvm::gt_first;
using tpusvm::lt_first;
using tpusvm::warp_winner;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int REG = 4;  // lanes a thread keeps in registers
constexpr int RUNNING = 0;
constexpr int CONVERGED = 1;
constexpr int NO_WORKING_SET = 2;
constexpr int MAX_ITER = 5;
constexpr int GUARD_TRIPPED = -1;

// A candidate lane of a reduction: its value and index, and the lane's own
// scalars that the pair step needs (alpha, y, K diagonal and, for the wss=2
// gain, row_h at the lane), so the winner's arrive with it and nothing is
// read back from memory after the reduction.
struct Arg {
  float v;
  int i;
  float a;
  float y;
  float d;
  float k;
};

__device__ __forceinline__ Arg arg_seed(float v) { return Arg{v, INT_MAX, 0.f, 0.f, 0.f, 0.f}; }

// lanes past REG * THREADS, in shared memory: six vectors (eight boxed)
__host__ __device__ int overflow_lanes(int q) { return q > REG * THREADS ? q - REG * THREADS : 0; }

// Per-warp partials of a block reduction, in two buffers used in turn: a
// buffer is written again only two reductions later, after a barrier that
// every reader of its last contents has passed.
struct Partials {
  Arg h[2][WARPS];
  Arg l[2][WARPS];
};

// Block-wide first argmin of h and first argmax of l (or l alone); every
// thread returns with the winners and their scalars. Each warp's winner is
// written by the lane that holds it; after the one __syncthreads every warp
// finds the block's winner among the partials and reads it.
template <bool WITH_H>
__device__ __forceinline__ void block_best(Arg& h, Arg& l, Partials& part, int& buf) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  if (WITH_H && tpusvm::holds_winner<true>(h.v, h.i)) part.h[buf][warp] = h;
  if (tpusvm::holds_winner<false>(l.v, l.i)) part.l[buf][warp] = l;
  __syncthreads();
  if (WITH_H) {
    const Arg x = lane < WARPS ? part.h[buf][lane] : arg_seed(INFINITY);
    h = part.h[buf][warp_winner<true>(x.v, x.i)];
  }
  const Arg x = lane < WARPS ? part.l[buf][lane] : arg_seed(-INFINITY);
  l = part.l[buf][warp_winner<false>(x.v, x.i)];
  buf ^= 1;
}

template <bool BATCHED, bool BOX>
__global__ void __launch_bounds__(THREADS)
inner_smo_kernel(const float* __restrict__ K, const float* __restrict__ y_in,
                 const float* __restrict__ a_in, const float* __restrict__ f_in,
                 const float* __restrict__ act_in, float C, const float* __restrict__ Cs,
                 const float* __restrict__ lo_in, const float* __restrict__ hi_in,
                 const int* __restrict__ boxed, float eps, float tau, int q, int max_inner,
                 int wss, int eta_exclude, float* __restrict__ a_out, int* __restrict__ stat) {
  bool box = BOX;
  if (BATCHED) {
    // lane blockIdx.x: its own slices and C
    const int b = blockIdx.x;
    C = Cs[b];
    const size_t v = static_cast<size_t>(b) * q;
    K += v * q;
    y_in += v;
    a_in += v;
    f_in += v;
    act_in += v;
    a_out += v;
    stat += 4 * b;
    if (BOX) {
      lo_in += v;
      hi_in += v;
      box = boxed[b] != 0;
    }
  }
  extern __shared__ float smem[];
  const int nover = overflow_lanes(q);
  float* o_a = smem;
  float* o_f = o_a + nover;
  float* o_y = o_f + nover;
  float* o_act = o_y + nover;
  float* o_d = o_act + nover;
  float* o_rh = o_d + nover;
  float* o_lo = o_rh + nover;  // BOX only
  float* o_hi = o_lo + nover;
  __shared__ Partials part;

  const float Cme = C - eps;
  const int tid = threadIdx.x;
  float ra[REG], rf[REG], ry[REG], ract[REG], rd[REG], rh[REG], rl[REG];
  // BOX: each lane's mask thresholds, lo + eps and hi - eps (eps and C -
  // eps on a lane not boxed)
  float rlo[REG], rhi[REG];
#pragma unroll
  for (int j = 0; j < REG; ++j) {
    const int i = tid + j * THREADS;
    const bool in = i < q;
    ra[j] = in ? a_in[i] : 0.f;
    rf[j] = in ? f_in[i] : 0.f;
    ry[j] = in ? y_in[i] : 0.f;
    ract[j] = in ? act_in[i] : 0.f;
    rd[j] = in ? K[(size_t)i * q + i] : 0.f;
    rh[j] = 0.f;
    rl[j] = 0.f;
    if (BOX) {
      rlo[j] = in && box ? lo_in[i] + eps : eps;
      rhi[j] = in && box ? hi_in[i] - eps : Cme;
    }
  }
  for (int i = tid + REG * THREADS; i < q; i += THREADS) {
    const int o = i - REG * THREADS;
    o_a[o] = a_in[i];
    o_f[o] = f_in[i];
    o_y[o] = y_in[i];
    o_act[o] = act_in[i];
    o_d[o] = K[(size_t)i * q + i];
    if (BOX) {
      o_lo[o] = box ? lo_in[i] + eps : eps;
      o_hi[o] = box ? hi_in[i] - eps : Cme;
    }
  }
  // every lane of this thread: fn(i, a, f, y, act, diag, row_h value,
  // mask thresholds: a > lo_e is "above its lower bound", a < hi_e "below
  // its upper")
  auto each = [&](auto&& fn) {
#pragma unroll
    for (int j = 0; j < REG; ++j) {
      const int i = tid + j * THREADS;
      if (i < q) fn(i, ra[j], rf[j], ry[j], ract[j], rd[j], rh[j], BOX ? rlo[j] : eps,
                    BOX ? rhi[j] : Cme);
    }
    for (int i = tid + REG * THREADS; i < q; i += THREADS) {
      const int o = i - REG * THREADS;
      fn(i, o_a[o], o_f[o], o_y[o], o_act[o], o_d[o], o_rh[o], BOX ? o_lo[o] : eps,
         BOX ? o_hi[o] : Cme);
    }
  };

  const float two_tau = 2.f * tau;
  int buf = 0;
  int n_upd = 0;
  int progress = 0;
  int reason = RUNNING;
  // every iteration updates (<= max_inner), shrinks one index (<= q) or ends
  const long long guard = (long long)max_inner + q + 2;
  long long it = 0;

  while (reason == RUNNING) {
    if (++it > guard) { reason = GUARD_TRIPPED; break; }

    // ---- first-order picks: b_h/i_h over I_high, b_l/i_l1 over I_low ----
    Arg H = arg_seed(INFINITY);
    Arg L = arg_seed(-INFINITY);
    each([&](int i, float& a, float& f, float& y, float& act, float& d, float&, float lo_e,
             float hi_e) {
      const bool on = act > 0.5f;
      const bool pos = y > 0.f;
      const bool lo = a > lo_e;
      const bool hi = a < hi_e;
      const bool mh = on && ((pos && hi) || (!pos && lo));
      const bool ml = on && ((pos && lo) || (!pos && hi));
      const float vhi = mh ? f : INFINITY;
      const float vli = ml ? f : -INFINITY;
      if (lt_first(vhi, i, H.v, H.i)) H = Arg{vhi, i, a, y, d, 0.f};
      if (gt_first(vli, i, L.v, L.i)) L = Arg{vli, i, a, y, d, 0.f};
    });
    block_best<true>(H, L, part, buf);

    const float bh = H.v;
    const float bl = L.v;
    const bool found = (bh < INFINITY) && (bl > -INFINITY);
    const bool converged = found && (bl <= bh + two_tau);
    const bool proceed = found && !converged;
    const int ih = min(H.i, q - 1);
    const int il1 = min(L.i, q - 1);
    const float* row_h = K + (size_t)ih * q;
    each([&](int i, float&, float&, float&, float&, float&, float& h, float, float) {
      h = row_h[i];
    });
    const float K11 = H.d;

    // the partner: its index, alpha, y, diag and K12 = row_h[i_l]
    int il = il1;
    Arg P = L;
    float K12;
    float g = -INFINITY;
    if (wss == 2) {
      // maximal-gain partner among violating I_low members
      Arg Gm = arg_seed(-INFINITY);
      each([&](int i, float& a, float& f, float& y, float& act, float& d, float& h,
               float lo_e, float hi_e) {
        const bool on = act > 0.5f;
        const bool pos = y > 0.f;
        const bool lo = a > lo_e;
        const bool hi = a < hi_e;
        const bool ml = on && ((pos && lo) || (!pos && hi));
        const float eta_raw = (K11 + d) - 2.f * h;
        const float eta_vec = fmaxf(eta_raw, 1e-12f);
        bool viol = ml && (f > bh);
        if (eta_exclude) viol = viol && (eta_raw > eps);
        const float diff = f - bh;
        const float vgi = viol ? (diff * diff) / eta_vec : -INFINITY;
        if (gt_first(vgi, i, Gm.v, Gm.i)) Gm = Arg{vgi, i, a, y, d, h};
      });
      block_best<false>(H, Gm, part, buf);
      g = Gm.v;
      if (eta_exclude && !(g > -INFINITY)) {
        K12 = row_h[il1];
      } else {
        il = min(Gm.i, q - 1);
        P = Gm;
        K12 = Gm.k;
      }
    } else {
      K12 = row_h[il1];
    }
    const float* row_l = K + (size_t)il * q;
#pragma unroll
    for (int j = 0; j < REG; ++j) {
      const int i = tid + j * THREADS;
      rl[j] = i < q ? row_l[i] : 0.f;
    }

    const float K22 = P.d;
    const float y_h = H.y;
    const float y_l = P.y;
    const float a_h = H.a;
    const float a_l = P.a;
    float b_l_pair = bl;
    if (wss == 2) {
      const float eta_l = fmaxf((K11 + K22) - 2.f * K12, 1e-12f);
      b_l_pair = bh + sqrtf(fmaxf(g, 0.f) * eta_l);
      if (eta_exclude) b_l_pair = (g > -INFINITY) ? b_l_pair : bl;
    }

    const tpusvm::PairStep st =
        BOX && box ? tpusvm::pair_step_box(K11, K22, K12, y_h, y_l, a_h, a_l, lo_in[ih], hi_in[ih],
                                           lo_in[il], hi_in[il], bh, b_l_pair, eps, proceed)
                   : tpusvm::pair_step(K11, K22, K12, y_h, y_l, a_h, a_l, bh, b_l_pair, C, eps,
                                       proceed);
    const float da_h = st.da_h;
    const float da_l = st.da_l;
    const float ch = da_h * y_h;
    const float cl = da_l * y_l;
    const bool ok = st.do_update && !st.stalled;
    const bool dead = proceed && (!st.feasible || !st.eta_ok || st.stalled);

    // two fused multiply-adds, as the reference's f + A*row_h + B*row_l
    // compiles (XLA contracts it); then the owner writes alpha and the
    // shrink (i_h == i_l forces eta == 0, hence zero deltas: the order is
    // safe)
#pragma unroll
    for (int j = 0; j < REG; ++j) rf[j] = __fmaf_rn(cl, rl[j], __fmaf_rn(ch, rh[j], rf[j]));
    for (int i = tid + REG * THREADS; i < q; i += THREADS) {
      const int o = i - REG * THREADS;
      o_f[o] = __fmaf_rn(cl, row_l[i], __fmaf_rn(ch, o_rh[o], o_f[o]));
    }
    each([&](int i, float& a, float&, float&, float& act, float&, float&, float, float) {
      if (i == ih) a = a_h + da_h;
      if (i == il) {
        a = a_l + da_l;
        if (dead) act = 0.f;
      }
    });

    n_upd += ok ? 1 : 0;
    progress = progress || ok;
    reason = !found ? NO_WORKING_SET
                    : converged ? CONVERGED : (n_upd >= max_inner ? MAX_ITER : RUNNING);
  }

  each([&](int i, float& a, float&, float&, float&, float&, float&, float, float) {
    a_out[i] = a;
  });
  if (tid == 0) {
    stat[0] = n_upd;
    stat[1] = progress;
    stat[2] = reason;
    stat[3] = (int)it;
  }
}

// Floors for one iteration of inner_smo_kernel, for its bound. mode 0 runs
// only the chain an iteration waits on: the block_best reductions (one, or
// two at wss=2), each fed by the previous result so none overlaps. mode 1
// only reads two q-float rows of K per iteration into registers, as the
// kernel does: at wss=1 both rows at once, at wss=2 the second row's
// address waiting on the first row's values, and each iteration's on the
// last one's. Neither scans the working set or computes the pair update, so
// each is a lower bound on the kernel's time per iteration. out holds
// 1024 floats.
__global__ void __launch_bounds__(THREADS)
iteration_floor_probe(const float* __restrict__ K, int q, int iters, int wss, int mode,
                      float* __restrict__ out) {
  __shared__ Partials part;
  const int tid = threadIdx.x;
  int buf = 0;
  float acc = 0.f;
  int ih = 0, il = 0;
  // the sum of this thread's lanes of row r
  auto row_sum = [&](int r) {
    const float* row = K + (size_t)r * q;
    float v[REG];
#pragma unroll
    for (int j = 0; j < REG; ++j) {
      const int i = tid + j * THREADS;
      v[j] = i < q ? row[i] : 0.f;
    }
    float s = 0.f;
    for (int i = tid + REG * THREADS; i < q; i += THREADS) s += row[i];
#pragma unroll
    for (int j = 0; j < REG; ++j) s += v[j];
    return s;
  };
  for (int it = 0; it < iters; ++it) {
    if (mode == 0) {
      Arg h{(float)((tid * 7 + ih) % 1021), tid, 0.f, 0.f, 0.f, 0.f};
      Arg l{(float)((tid * 13 + il) % 1019), tid, 0.f, 0.f, 0.f, 0.f};
      block_best<true>(h, l, part, buf);
      ih = h.i;
      il = l.i;
      if (wss == 2) {
        Arg gm{(float)((tid * 5 + il) % 1013), tid, 0.f, 0.f, 0.f, 0.f};
        block_best<false>(h, gm, part, buf);
        il = gm.i;
      }
    } else {
      const int dep = (int)(acc * 0.f);
      const int rh = (2 * it + dep) % q;
      const int rl = (2 * it + 1 + dep) % q;
      if (wss == 2) {
        const float s = row_sum(rh);
        acc += s + row_sum((rl + (int)(s * 0.f)) % q);
      } else {
        acc += row_sum(rh) + row_sum(rl);
      }
    }
  }
  for (int k = tid; k < 1024; k += THREADS) out[k] = acc + (float)(ih + il);
}

}  // namespace

extern "C" int tpusvm_inner_smo_floor_probe(const float* K, int q, int iters, int wss, int mode,
                                            float* out, cudaStream_t stream) {
  iteration_floor_probe<<<1, THREADS, 0, stream>>>(K, q, iters, wss, mode, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpusvm_inner_smo_smem_bytes(int q, int boxed) {
  return (boxed ? 8 : 6) * overflow_lanes(q) * (int)sizeof(float);
}

template <bool BATCHED, bool BOX>
static int launch(int blocks, const float* K, const float* y, const float* a, const float* f,
                  const float* act, float C, const float* Cs, const float* lo, const float* hi,
                  const int* boxed, float eps, float tau, int q, int max_inner, int wss,
                  int eta_exclude, float* a_out, int* stat, cudaStream_t stream) {
  const int smem = tpusvm_inner_smo_smem_bytes(q, BOX);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        inner_smo_kernel<BATCHED, BOX>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  inner_smo_kernel<BATCHED, BOX><<<blocks, THREADS, smem, stream>>>(
      K, y, a, f, act, C, Cs, lo, hi, boxed, eps, tau, q, max_inner, wss, eta_exclude, a_out,
      stat);
  return static_cast<int>(cudaGetLastError());
}

// lo/hi (q,): the boxed subproblem on deltas (a holds them), or null for
// the plain one on alphas in [0, C]
extern "C" int tpusvm_inner_smo(const float* K, const float* y, const float* a, const float* f,
                                const float* act, float C, const float* lo, const float* hi,
                                float eps, float tau, int q, int max_inner, int wss,
                                int eta_exclude, float* a_out, int* stat, cudaStream_t stream) {
  if (lo != nullptr)
    return launch<false, true>(1, K, y, a, f, act, C, nullptr, lo, hi, nullptr, eps, tau, q,
                               max_inner, wss, eta_exclude, a_out, stat, stream);
  return launch<false, false>(1, K, y, a, f, act, C, nullptr, nullptr, nullptr, nullptr, eps,
                              tau, q, max_inner, wss, eta_exclude, a_out, stat, stream);
}

// B stacked working sets: K (B, q, q), y/a/f/act/a_out (B, q), Cs (B,),
// stat (B, 4); one block a lane. lo/hi (B, q) and boxed (B,): the lanes
// with boxed[b] != 0 run the boxed subproblem; all null for none.
extern "C" int tpusvm_inner_smo_batched(const float* K, const float* y, const float* a,
                                        const float* f, const float* act, const float* Cs,
                                        const float* lo, const float* hi, const int* boxed,
                                        float eps, float tau, int q, int max_inner, int wss,
                                        int eta_exclude, int B, float* a_out, int* stat,
                                        cudaStream_t stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  if (boxed != nullptr)
    return launch<true, true>(B, K, y, a, f, act, 0.f, Cs, lo, hi, boxed, eps, tau, q, max_inner,
                              wss, eta_exclude, a_out, stat, stream);
  return launch<true, false>(B, K, y, a, f, act, 0.f, Cs, nullptr, nullptr, nullptr, eps, tau, q,
                             max_inner, wss, eta_exclude, a_out, stat, stream);
}
