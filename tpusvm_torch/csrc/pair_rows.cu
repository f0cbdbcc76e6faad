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
// d=784); the k*n*d FMAs are 1.9 GFLOP at k=20, 28 us at the f32 FMA rate.
//
// Design: the needed query rows x_{idx[r]} are staged in shared memory (in
// groups of at most 32, so X streams once whenever k <= 32 and the group
// fits); each warp streams R consecutive rows of X at a time with coalesced
// loads, each lane keeping one partial sum per (row, query row) over its
// strided elements t = lane, lane+32, ... (IEEE fmaf, in order), so a query
// value read from shared memory serves R rows; a butterfly of xor shuffles
// adds the 32 partials (every lane ends with the same bits). The loop over
// t is unrolled so that R x UNROLL loads of X are in flight a warp: the
// kernel is bound by the latency of those loads more than by the FMAs
// (PERF.md section 6). R and UNROLL per k were picked on the card; every
// choice gives the same bits. The dot of a (row r,
// column j) pair therefore has one fixed order, whatever k, the grid or the
// other flags: a row recomputed for the same index has the same bits, so the
// skip is a speed measure only. Lane s then applies the family's epilogue
// to query row s and writes it.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_K = 256;
constexpr int SMEM_BUDGET = 160 * 1024;

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

template <int MAXS, int R, int UNROLL>
__global__ void __launch_bounds__(THREADS)
    pair_rows_kernel(const float* __restrict__ X, int n, int d, const long long* __restrict__ idx,
                     const unsigned char* __restrict__ need, int k, const float* __restrict__ sn,
                     float* __restrict__ rows, int family, float gamma, float coef0, int degree,
                     int group) {
  extern __shared__ float qrows[];  // [group][d]
  __shared__ int slot[MAX_K];
  __shared__ long long src[MAX_K];
  __shared__ float snq[MAX_K];
  __shared__ int n_need;
  if (threadIdx.x == 0) {
    int m = 0;
    for (int r = 0; r < k; ++r) {
      if (need[r]) {
        slot[m] = r;
        src[m] = idx[r];
        ++m;
      }
    }
    n_need = m;
  }
  __syncthreads();
  const int m = n_need;
  if (m == 0) return;  // the cache skip: every row is still current
  if (family == RBF) {
    for (int s = threadIdx.x; s < m; s += THREADS) snq[s] = sn[src[s]];
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int g0 = 0; g0 < m; g0 += group) {
    const int gm = min(group, m - g0);
    __syncthreads();  // the previous group's reads of qrows are done
    for (int s = 0; s < gm; ++s) {
      const float* xs = X + src[g0 + s] * (long long)d;
      for (int t = threadIdx.x; t < d; t += THREADS) qrows[s * d + t] = xs[t];
    }
    __syncthreads();
    // each warp takes R consecutive rows of X at a time: every query value
    // read from shared memory serves R rows, and R loads are in flight
    for (long long j0 = ((long long)blockIdx.x * WARPS + warp) * R; j0 < n;
         j0 += (long long)gridDim.x * WARPS * R) {
      const float* xj = X + j0 * d;
      float acc[R][MAXS];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int s = 0; s < MAXS; ++s) acc[r][s] = 0.f;
#pragma unroll UNROLL
      for (int t = lane; t < d; t += 32) {
        float x[R];
#pragma unroll
        for (int r = 0; r < R; ++r) x[r] = j0 + r < n ? xj[(long long)r * d + t] : 0.f;
#pragma unroll
        for (int s = 0; s < MAXS; ++s) {
          if (s < gm) {
            const float q = qrows[s * d + t];
#pragma unroll
            for (int r = 0; r < R; ++r) acc[r][s] = __fmaf_rn(x[r], q, acc[r][s]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float mine = 0.f;
#pragma unroll
        for (int s = 0; s < MAXS; ++s) {
          if (s < gm) {
            float v = acc[r][s];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
            if (lane == s) mine = v;
          }
        }
        const long long j = j0 + r;
        if (lane < gm && j < n) {
          const int s = g0 + lane;
          const float snj = family == RBF ? sn[j] : 0.f;
          rows[(long long)slot[s] * n + j] =
              epilogue(mine, family, gamma, coef0, degree, family == RBF ? snq[s] : 0.f, snj);
        }
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

template <int MAXS, int R, int UNROLL>
int launch(const float* X, int n, int d, const long long* idx, const unsigned char* need, int k,
           const float* sn, float* rows, int family, float gamma, float coef0, int degree,
           cudaStream_t stream) {
  // query rows a pass: at most MAXS, and within the shared-memory budget
  int group = std::min(MAXS, k);
  while (group > 1 && (long long)group * d * 4 > SMEM_BUDGET) --group;
  const int smem = group * d * (int)sizeof(float);
  if (smem > SMEM_BUDGET) return -4001;  // one row of X does not fit
  // the attribute and the occupancy are set up once per process and shared-
  // memory size, on the first call (the solver's eager first chunk, before
  // any graph capture)
  static int raised = 48 * 1024;
  static int sized_for = -1;
  static int per_sm = 1;
  auto kernel = pair_rows_kernel<MAXS, R, UNROLL>;
  if (smem > raised) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = smem;
  }
  if (smem != sized_for) {
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    per_sm = std::max(per_sm, 1);
    sized_for = smem;
  }
  const long long want = ((long long)n + WARPS * R - 1) / (WARPS * R);
  const int blocks = (int)std::min<long long>(want, (long long)per_sm * sm_count());
  kernel<<<std::max(blocks, 1), THREADS, smem, stream>>>(X, n, d, idx, need, k, sn, rows, family,
                                                        gamma, coef0, degree, group);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tpusvm_pair_rows(const float* X, int n, int d, const long long* idx,
                                const unsigned char* need, int k, const float* sn, float* rows,
                                int family, float gamma, float coef0, int degree,
                                cudaStream_t stream) {
  if (k < 1 || k > MAX_K) return -4000;
  // (slots, rows a warp, loop unroll) timed on the card at n=60000, d=784
  if (k <= 2)
    return launch<2, 4, 4>(X, n, d, idx, need, k, sn, rows, family, gamma, coef0, degree, stream);
  if (k <= 8)
    return launch<8, 2, 8>(X, n, d, idx, need, k, sn, rows, family, gamma, coef0, degree, stream);
  return launch<32, 2, 4>(X, n, d, idx, need, k, sn, rows, family, gamma, coef0, degree, stream);
}
