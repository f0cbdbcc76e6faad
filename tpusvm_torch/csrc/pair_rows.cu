// The pair solver's K-row refresh: rows[r][j] = K(x_{idx[r]}, x_j) for every
// r whose need[r] is set, written in place; rows whose flag is clear are left
// untouched, and when no flag is set the kernel returns at once.
//
// No TPU counterpart: the JAX pair solver computes its two rows in XLA
// (tpusvm/ops/rbf.py:140, rbf_rows_at, behind a lax.cond on "an index
// changed", tpusvm/solver/smo.py:105-123). A CUDA graph cannot branch on the
// host, so the cache skip moves into the kernel: it reads `need` from device
// memory, and the captured step launches it every iteration.
//
// What bounds it on an H100: X, read once from device memory for all the
// rows it refreshes (n*d*4 bytes: 188 MB, 56 us at 3.35 TB/s at n=60000,
// d=784). The k*n*d FMAs (0.94 G at k=20, 32 us at the f32 FMA rate) and
// their operands' shared-memory traffic come close to it at k=20, so the
// design spends as few issue slots as it can on anything but the FMAs.
//
// The arithmetic, fixed for every k, grid and flag pattern: the dot of row
// j with query row s is the sum over the 32 lanes of lane-strided partial
// sums (lane l: t = l, l+32, ... in order, IEEE fmaf from 0), added by the
// xor butterfly's tree (offsets 16, 8, 4, 2, 1). A row recomputed for the
// same index therefore has the same bits whatever k or the other flags,
// so the skip is a speed measure only (the lockstep heads' equality with
// their solo runs rests on this).
//
// Design: persistent blocks (one an SM), one producer warp and CONSUMERS
// consumer warps.
// - X streams through a ring of shared-memory stages, each a slab of whole
//   consecutive rows (a multiple of 8, so every slab starts 32-byte aligned
//   for any d) filled by ONE 1-D bulk copy (cp.async.bulk, completion on an
//   mbarrier) issued by the producer's lane 0, and for RBF a second one of
//   the slab's sn; the last n*d % 4 floats, which a 16-byte copy cannot
//   carry, are stored by the producer itself. Loads in flight cost the
//   consumers no registers and no issue slots, and no consumer waits on a
//   device-memory load inside a task.
// - The needed query rows sit in shared memory transposed, qt[t][s] with a
//   row pitch G = 2 mod 4, so a lane reads two query slots with one
//   conflict-free 8-byte load. They are gathered with 32 loads in flight a
//   thread: a load behind a branch waits for the one before it.
// - A consumer task is 8 rows of a slab against S query slots: 8*S
//   accumulators a lane, each X value read from shared memory once for S
//   FMAs and each query value once for 8. S is a template (2, 4, 8, 10:
//   k=2 is the binary pair solver, k=20 ten lockstep heads), so no
//   accumulator is dead at the paths' k.
// - The 8*S lane partials are reduced by a reduce-scatter of the same
//   butterfly: at each offset a lane keeps half of its values and trades
//   the other half, so a (row, query) sum costs about one shuffle, not
//   five, and ends on one lane pair with the butterfly's bits (fadd is
//   commutative, so both lanes of a pair compute each node alike).
// - When not even two stages of 8 rows fit beside one query row (d above
//   about 2,100 at k > 8, 3,100 at k <= 2), consumers read X and the query
//   rows from device memory with plain loads in the same order (the direct
//   path), so no d is too large.
// Measured on the card (PERF.md section 6): at k=2 the ring runs at the
// rate of a plain read of X (torch's X.sum()); at k=20 the FMAs, their
// shared-memory operands, the reduction and the epilogue take about as
// long as the X pass, and the two overlap only in part.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CONSUMERS = 8;                    // consumer warps a block
constexpr int THREADS = (CONSUMERS + 1) * 32;  // and one producer warp
constexpr int ROWS = 8;                         // rows of X a consumer task
constexpr int MAX_K = 256;
constexpr int MAX_STAGES = 8;
constexpr int MIN_STAGES = 4;
constexpr int QLOADS = 32;                      // query-row loads in flight a thread
constexpr long long SMEM_BUDGET = 220 * 1024;   // dynamic shared memory a block
constexpr long long STAGE_TARGET = 24 * 1024;
constexpr unsigned FULL_MASK = 0xffffffffu;


enum Family { RBF = 0, LINEAR = 1, POLY = 2, SIGMOID = 3 };

// x ** degree as jax.lax.integer_pow expands it: square and multiply, low
// bit first, each product rounded
__device__ __forceinline__ float integer_pow(float x, int degree) {
  float acc = 0.f;
  bool have = false;
  int y = degree;
  while (y > 0) {
    if (y & 1) {
      acc = have ? __fmul_rn(acc, x) : x;
      have = true;
    }
    y >>= 1;
    if (y > 0) x = __fmul_rn(x, x);
  }
  return acc;
}

__device__ __forceinline__ float epilogue(float dot, int family, float gamma, float coef0,
                                          int degree, float sn_i, float sn_j) {
  switch (family) {
    case RBF: {
      // (sn_i + sn_j) - 2 dot, clamped at 0, then exp(-gamma d2)
      const float d2 = fmaxf(__fsub_rn(__fadd_rn(sn_i, sn_j), __fmul_rn(2.0f, dot)), 0.0f);
      return expf(__fmul_rn(-gamma, d2));
    }
    case LINEAR:
      return dot;
    case POLY:
      return integer_pow(__fadd_rn(__fmul_rn(gamma, dot), coef0), degree);
    default:
      return tanhf(__fadd_rn(__fmul_rn(gamma, dot), coef0));
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
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

// one arrival that also expects `bytes` of bulk copies in this phase
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory by the copy engine, completing on bar
__device__ __forceinline__ void bulk_copy(uint32_t dst, const float* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the consumer warps only (the producer warp does not take part)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS * 32) : "memory");
}

// Lane partials of ROWS rows of X (row r at xs + r*ldx; rows from
// rows_valid on repeat the last valid one) against S query slots: column t
// of slot s at qt[t*G + s0 + s], or with DIRECT at qr[s][t].
// acc[(h*ROWS + r)*S/2 + i] is row r against slot h*S/2 + i.
template <int S, bool DIRECT>
__device__ __forceinline__ void tile_dots(const float* xs, long long ldx, int rows_valid,
                                          const float* qt, int G, int s0,
                                          const float* const* qr, int d, int lane,
                                          float (&acc)[ROWS * S]) {
  constexpr int S2 = S / 2;
  const float* xr[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) xr[r] = xs + (long long)min(r, rows_valid - 1) * ldx;
#pragma unroll
  for (int i = 0; i < ROWS * S; ++i) acc[i] = 0.f;
#pragma unroll 2
  for (int t = lane; t < d; t += 32) {
    float x[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) x[r] = xr[r][t];
    float q[S];
    if constexpr (DIRECT) {
#pragma unroll
      for (int s = 0; s < S; ++s) q[s] = qr[s][t];
    } else {
      // two slots with one 8-byte load
      const float2* qv = reinterpret_cast<const float2*>(qt + (long long)t * G + s0);
#pragma unroll
      for (int p = 0; p < S2; ++p) {
        const float2 v = qv[p];
        q[2 * p] = v.x;
        q[2 * p + 1] = v.y;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int i = 0; i < S2; ++i) {
          float& a = acc[(h * ROWS + r) * S2 + i];
          a = __fmaf_rn(x[r], q[h * S2 + i], a);
        }
  }
}

// One reduce-scatter step of the butterfly at offset `off`: the lane with
// that bit set keeps the upper HALF values, its partner the lower, and each
// adds the partner's copy of the values it keeps.
template <int M, int HALF>
__device__ __forceinline__ void halve(float (&acc)[M], int lane, int off) {
  const bool up = (lane & off) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = up ? acc[i] : acc[i + HALF];
    const float keep = up ? acc[i + HALF] : acc[i];
    acc[i] = __fadd_rn(keep, __shfl_xor_sync(FULL_MASK, send, off));
  }
}

// After it, acc[i] on lane l is the full dot of row (l >> 1) & 7 with slot
// (l >> 4)*S/2 + i, on both lanes of the pair (l, l^1).
template <int S>
__device__ __forceinline__ void reduce_tile(float (&acc)[ROWS * S], int lane) {
  constexpr int M = ROWS * S;
  halve<M, M / 2>(acc, lane, 16);
  halve<M, M / 4>(acc, lane, 8);
  halve<M, M / 8>(acc, lane, 4);
  halve<M, M / 16>(acc, lane, 2);
#pragma unroll
  for (int i = 0; i < S / 2; ++i) acc[i] = __fadd_rn(acc[i], __shfl_xor_sync(FULL_MASK, acc[i], 1));
}

// DIRECT: the direct path, a kernel of its own so that its registers do
// not weigh on the ring's
template <int S, bool DIRECT>
__global__ void __launch_bounds__(THREADS, 1)
    pair_rows_kernel(const float* __restrict__ X, int n, int d, const long long* __restrict__ idx,
                     const unsigned char* __restrict__ need, int k, const float* __restrict__ sn,
                     float* __restrict__ rows, int family, float gamma, float coef0, int degree,
                     int group, int G, int slab_rows, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full_bar[MAX_STAGES];
  __shared__ __align__(8) uint64_t empty_bar[MAX_STAGES];
  __shared__ int slot[MAX_K];
  __shared__ long long src[MAX_K];
  __shared__ float snq[MAX_K];
  __shared__ int warp_count[THREADS / 32];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // the flagged r in order: slot[s] is the s-th of them
  const bool flag = tid < k && need[tid];
  const unsigned ballot = __ballot_sync(FULL_MASK, flag);
  if (lane == 0) warp_count[warp] = __popc(ballot);
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  int m = 0, before = 0;
  for (int w = 0; w < THREADS / 32; ++w) {
    if (w == warp) before = m;
    m += warp_count[w];
  }
  if (flag) {
    const int s = before + __popc(ballot & ((1u << lane) - 1u));
    slot[s] = tid;
    src[s] = idx[tid];
  }
  __syncthreads();
  if (m == 0) return;  // the cache skip: every row is still current

  float* ring = reinterpret_cast<float*>(smem);
  // a stage: the slab's rows of X, then their sn (RBF)
  const bool rbf = family == RBF;
  const long long stage_floats = (long long)slab_rows * (rbf ? d + 1 : d);
  float* qt = ring + stages * stage_floats;
  const int n_slabs = (n + slab_rows - 1) / slab_rows;

  if (warp == CONSUMERS) {
    // ---- producer: one lane keeps the ring full, pass after pass -------
    if (DIRECT || lane != 0) return;
    int st = 0;
    uint32_t phase = 0;   // of the stage's current use
    bool reuse = false;   // the ring has gone round once
    for (int g0 = 0; g0 < m; g0 += group) {
      for (int slab = blockIdx.x; slab < n_slabs; slab += gridDim.x) {
        if (reuse) mbar_wait(smem_u32(&empty_bar[st]), phase ^ 1);
        const long long j0 = (long long)slab * slab_rows;
        const long long nfl = min((long long)slab_rows, (long long)n - j0) * d;
        const long long bulk = nfl & ~3LL;
        float* dst = ring + st * stage_floats;
        const float* from = X + j0 * d;
        const uint32_t bar = smem_u32(&full_bar[st]);
        // RBF: the slab's sn after its rows, by the same rule
        const int rows_in = (int)(nfl / d);
        const int sn_bulk = rbf ? rows_in & ~3 : 0;
        float* sdst = dst + (long long)slab_rows * d;
        for (long long e = bulk; e < nfl; ++e) dst[e] = from[e];
        if (rbf)
          for (int e = sn_bulk; e < rows_in; ++e) sdst[e] = sn[j0 + e];
        mbar_arrive_expect(bar, (uint32_t)((bulk + sn_bulk) * 4));
        if (bulk > 0) bulk_copy(smem_u32(dst), from, (uint32_t)(bulk * 4), bar);
        if (sn_bulk > 0) bulk_copy(smem_u32(sdst), sn + j0, (uint32_t)(sn_bulk * 4), bar);
        if (++st == stages) {
          st = 0;
          phase ^= 1;
          reuse = true;
        }
      }
    }
    return;
  }

  // ---- consumers -------------------------------------------------------
  if (rbf)
    for (int s = tid; s < m; s += CONSUMERS * 32) snq[s] = sn[src[s]];
  constexpr int S2 = S / 2;
  const bool writer = (lane & 1) == 0;
  const int h = lane >> 4;
  const int r_out = (lane >> 1) & 7;
  int st = 0;           // the ring stage of the next slab
  uint32_t phase = 0;   // and the parity of its fill
  int turn = 0;         // the warp that takes a slab's first task
  for (int g0 = 0; g0 < m; g0 += group) {
    const int gm = min(group, m - g0);
    const int nsg = (gm + S - 1) / S;
    if constexpr (!DIRECT) {
      consumer_sync();  // the previous pass's reads of qt are done
      // the group's rows, transposed into qt: QLOADS loads in flight a
      // thread before any of their stores (unconditional, at a clamped
      // index, so that none waits on another)
      const int total = gm * d;
      for (int e0 = tid; e0 < total; e0 += QLOADS * CONSUMERS * 32) {
        float v[QLOADS];
        int at[QLOADS];
#pragma unroll
        for (int u = 0; u < QLOADS; ++u) {
          const int e = min(e0 + u * CONSUMERS * 32, total - 1);
          const int s = e / d;
          const int t = e - s * d;
          v[u] = X[src[g0 + s] * d + t];
          at[u] = t * G + s;
        }
#pragma unroll
        for (int u = 0; u < QLOADS; ++u)
          if (e0 + u * CONSUMERS * 32 < total) qt[at[u]] = v[u];
      }
    }
    consumer_sync();  // qt and snq are written

    // one task: 8 rows from j0 against the slots of subgroup sg, written
    // by the even lanes (lanes l and l^1 hold the same sums)
    auto task = [&](const float* xs, int rows_valid, long long j0, int sg, const float* snx) {
      float acc[ROWS * S];
      const long long j = j0 + r_out;
      // before the dots: from device memory (the direct path) a load takes
      // microseconds under a saturated memory system
      const float snj = (rbf && writer && j < n) ? snx[r_out] : 0.f;
      // the direct path's query rows, from device memory; slots past the
      // group repeat its last row, and their sums are never written
      const float* qr[DIRECT ? S : 1];
      if constexpr (DIRECT) {
#pragma unroll
        for (int s = 0; s < S; ++s) qr[s] = X + src[g0 + min(sg * S + s, gm - 1)] * d;
      }
      tile_dots<S, DIRECT>(xs, d, rows_valid, qt, G, sg * S, qr, d, lane, acc);
      reduce_tile<S>(acc, lane);
      if (writer && j < n) {
#pragma unroll
        for (int i = 0; i < S2; ++i) {
          const int s = sg * S + h * S2 + i;
          if (s < gm) {
            rows[(long long)slot[g0 + s] * n + j] =
                epilogue(acc[i], family, gamma, coef0, degree, rbf ? snq[g0 + s] : 0.f, snj);
          }
        }
      }
    };

    if constexpr (!DIRECT) {
      for (int slab = blockIdx.x; slab < n_slabs; slab += gridDim.x) {
        mbar_wait(smem_u32(&full_bar[st]), phase);
        const long long j0 = (long long)slab * slab_rows;
        const int valid = (int)min((long long)slab_rows, (long long)n - j0);
        const int tasks = ((valid + ROWS - 1) / ROWS) * nsg;
        const float* stage = ring + st * stage_floats;
        // rows past `valid` in the last slab read stale stage data; their
        // sums are never written
        for (int t = (warp - turn + CONSUMERS) % CONSUMERS; t < tasks; t += CONSUMERS) {
          const int tile = t / nsg;
          task(stage + (long long)tile * ROWS * d, ROWS, j0 + tile * ROWS, t - tile * nsg,
               stage + (long long)slab_rows * d + tile * ROWS);
        }
        turn = (turn + tasks) % CONSUMERS;
        __syncwarp();
        if (lane == 0) mbar_arrive(smem_u32(&empty_bar[st]));
        if (++st == stages) {
          st = 0;
          phase ^= 1;
        }
      }
    } else {
      // the direct path: X from device memory with plain loads
      const long long tasks = (((long long)n + ROWS - 1) / ROWS) * nsg;
      for (long long t = (long long)blockIdx.x * CONSUMERS + warp; t < tasks;
           t += (long long)gridDim.x * CONSUMERS) {
        const long long tile = t / nsg;
        const long long j0 = tile * ROWS;
        task(X + j0 * d, (int)min((long long)ROWS, (long long)n - j0), j0, (int)(t - tile * nsg),
             sn + j0);
      }
    }
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      count = 132;
  }
  return count;
}

template <int S>
int padded_group(int g) {
  // a multiple of S (a subgroup never reads past the pitch), 2 mod 4 (an
  // 8-byte load of two slots is free of bank conflicts)
  const int G = (g + S - 1) / S * S;
  return G % 4 == 0 ? G + 2 : G;
}

template <int S, bool DIRECT>
int start_kernel(long long want, int smem, cudaStream_t stream, const float* X, int n, int d,
                 const long long* idx, const unsigned char* need, int k, const float* sn,
                 float* rows, int family, float gamma, float coef0, int degree, int group, int G,
                 int slab_rows, int stages) {
  // the attribute and the occupancy are set up once per process and shared-
  // memory size, on the first call (the solver's eager first chunk, before
  // any graph capture)
  static bool raised = false;
  static int sized_for = -1;
  static int per_sm = 1;
  auto kernel = pair_rows_kernel<S, DIRECT>;
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BUDGET);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  if (smem != sized_for) {
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    per_sm = std::max(per_sm, 1);
    sized_for = smem;
  }
  const int blocks = (int)std::min<long long>(want, (long long)per_sm * sm_count());
  kernel<<<std::max(blocks, 1), THREADS, smem, stream>>>(X, n, d, idx, need, k, sn, rows, family,
                                                        gamma, coef0, degree, group, G,
                                                        slab_rows, stages);
  return static_cast<int>(cudaGetLastError());
}

template <int S>
int launch(const float* X, int n, int d, const long long* idx, const unsigned char* need, int k,
           const float* sn, float* rows, int family, float gamma, float coef0, int degree,
           cudaStream_t stream) {
  const long long row_bytes = 4LL * d;
  const int sms = sm_count();
  // rows a slab: a multiple of ROWS, about STAGE_TARGET bytes, and few enough
  // that every SM gets several slabs
  const long long by_bytes = std::max(1LL, STAGE_TARGET / (ROWS * row_bytes));
  const long long by_count =
      std::max(1LL, ((long long)n + 4LL * ROWS * sms - 1) / (4LL * ROWS * sms));
  const int slab_rows = (int)(ROWS * std::min(by_bytes, by_count));
  const long long stage_bytes = slab_rows * (row_bytes + (family == RBF ? 4 : 0));
  // the largest query group that leaves MIN_STAGES stages, else 2 stages,
  // else the direct path, which holds no query row in shared memory
  int group = 0, stages = 0;
  for (int want = MIN_STAGES; want >= 2 && group == 0; want -= 2) {
    for (int g = k; g >= 1; --g) {
      const long long left = SMEM_BUDGET - padded_group<S>(g) * row_bytes;
      const long long st = left < 0 ? 0 : std::min<long long>(MAX_STAGES, left / stage_bytes);
      if (st >= want) {
        group = g;
        stages = (int)st;
        break;
      }
    }
  }
  if (group == 0) group = k;
  const int G = stages > 0 ? padded_group<S>(group) : 0;
  const int smem = (int)(stages * stage_bytes + G * row_bytes);
  long long want;
  if (stages > 0) {
    want = ((long long)n + slab_rows - 1) / slab_rows;
  } else {
    const long long tasks = ((long long)n + ROWS - 1) / ROWS * ((group + S - 1) / S);
    want = (tasks + CONSUMERS - 1) / CONSUMERS;
  }
  auto start = stages > 0 ? start_kernel<S, false> : start_kernel<S, true>;
  return start(want, smem, stream, X, n, d, idx, need, k, sn, rows, family, gamma, coef0, degree,
               group, G, slab_rows, stages);
}

}  // namespace

extern "C" int tpusvm_pair_rows(const float* X, int n, int d, const long long* idx,
                                const unsigned char* need, int k, const float* sn, float* rows,
                                int family, float gamma, float coef0, int degree,
                                cudaStream_t stream) {
  if (k < 1 || k > MAX_K) return -4000;
  // the bulk copies' alignment
  if (reinterpret_cast<uintptr_t>(X) % 16 != 0 ||
      (family == RBF && reinterpret_cast<uintptr_t>(sn) % 16 != 0))
    return -4002;
  // query slots a consumer task: no dead slot at the paths' k (2: the
  // binary pair solver; 20: ten lockstep heads, two tasks of 10)
  if (k <= 2)
    return launch<2>(X, n, d, idx, need, k, sn, rows, family, gamma, coef0, degree, stream);
  if (k <= 4)
    return launch<4>(X, n, d, idx, need, k, sn, rows, family, gamma, coef0, degree, stream);
  if (k <= 8)
    return launch<8>(X, n, d, idx, need, k, sn, rows, family, gamma, coef0, degree, stream);
  return launch<10>(X, n, d, idx, need, k, sn, rows, family, gamma, coef0, degree, stream);
}
