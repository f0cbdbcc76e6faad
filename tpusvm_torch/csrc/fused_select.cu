// The f-update with fused working-set candidate selection.
//
// Replaces the TPU kernel fused_fupdate_select_pallas (_make_select_kernel,
// tpusvm/ops/pallas/fused_fupdate.py): df_i = sum_k coef_k K(x_i, xb_k) for
// all rows, and, per block of `block` rows, the k_cand smallest-key I_high
// candidates and the k_cand largest-key I_low candidates of the updated f,
// so that the solver's next round selects from nb*k_cand candidates
// instead of masking and sorting all n rows.
//
// Semantics of the epilogue, the TPU kernel's exactly:
//   - keys are f32(f) + df, rounded once in f32; masks come from the f32
//     post-round alpha against f32 C - eps and eps; y_eff = 0 (an invalid
//     row) is in neither set; rows >= n are in neither set;
//   - each pick takes the extreme key among the rows not yet picked and,
//     among equal keys, the LAST row (the TPU kernel's
//     max(where(cand, rows, -1))), so once a block runs out of members its
//     +-inf fillers are its largest unpicked rows, which in the last block
//     are rows >= n; indices are global (block start + row).
//
// What bounds it on an H100: the df contraction, 2*n*d*q flops (192.7
// GFLOP at n=60000, d=784, q=2048), as for fused_fupdate.cu: 3xTF32 on the
// tensor cores, 1.168 ms at 495 TFLOP/s, with the chosen unit's 9.0 GB of
// L2 reads next; the epilogue reads 4 floats per row and writes
// 4*nb*k_cand values, nothing next to that.
//
// Design, in four launches on one stream: (1) to (3) the f-update of
// rbf_tile.cuh (X_B's TF32 split, the TMA + wgmma main loop over
// (row block, column tile) units, the fixed-order sum of their partials),
// the same code and flags as fused_fupdate.cu, so df is bit-identical to
// it; (4) an epilogue kernel, one block of 256 threads per row block: keys
// into shared memory, then k_cand rounds of a block-wide (key, row)
// reduction with the last row winning ties, for I_high and I_low together,
// the winner marked picked. Fusing (4) into the main loop is later work: a
// row's df is complete only once every column tile's unit has run.

#include <cuda_runtime.h>
#include <math.h>

#include "rbf_tile.cuh"

namespace {

constexpr int SEL_THREADS = 256;
constexpr int SEL_WARPS = SEL_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// (key, row) orders with the LAST row winning ties, seeded with (+-inf, -1)
__device__ __forceinline__ bool lt_last(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i > bi);
}
__device__ __forceinline__ bool gt_last(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i > bi);
}

__device__ __forceinline__ void warp_pick(float& vu, int& iu, float& vl, int& il) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ovu = __shfl_xor_sync(FULL, vu, off);
    const int oiu = __shfl_xor_sync(FULL, iu, off);
    const float ovl = __shfl_xor_sync(FULL, vl, off);
    const int oil = __shfl_xor_sync(FULL, il, off);
    if (lt_last(ovu, oiu, vu, iu)) { vu = ovu; iu = oiu; }
    if (gt_last(ovl, oil, vl, il)) { vl = ovl; il = oil; }
  }
}

__global__ void __launch_bounds__(SEL_THREADS)
select_candidates_kernel(const float* __restrict__ df, const float* __restrict__ f32_f,
                         const float* __restrict__ alpha, const int* __restrict__ y_eff,
                         float C, float eps, int n, int block, int k_cand,
                         float* __restrict__ up_val, int* __restrict__ up_idx,
                         float* __restrict__ low_val, int* __restrict__ low_idx) {
  extern __shared__ float sm[];
  float* key_up = sm;
  float* key_lo = sm + block;
  unsigned char* picked_up = reinterpret_cast<unsigned char*>(sm + 2 * block);
  unsigned char* picked_lo = picked_up + block;
  __shared__ float wvu[SEL_WARPS], wvl[SEL_WARPS];
  __shared__ int wiu[SEL_WARPS], wil[SEL_WARPS];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int base = blockIdx.x * block;
  const float Cme = C - eps;
  for (int r = tid; r < block; r += SEL_THREADS) {
    const int gi = base + r;
    float ku = INFINITY, kl = -INFINITY;
    if (gi < n) {
      const float f_new = f32_f[gi] + df[gi];
      const float a = alpha[gi];
      const int ye = y_eff[gi];
      const bool mh = ye == 1 ? a < Cme : (ye == -1 && a > eps);
      const bool ml = ye == 1 ? a > eps : (ye == -1 && a < Cme);
      if (mh) ku = f_new;
      if (ml) kl = f_new;
    }
    key_up[r] = ku;
    key_lo[r] = kl;
    picked_up[r] = 0;
    picked_lo[r] = 0;
  }
  __syncthreads();

  for (int k = 0; k < k_cand; ++k) {
    float vu = INFINITY; int iu = -1;
    float vl = -INFINITY; int il = -1;
    for (int r = tid; r < block; r += SEL_THREADS) {
      if (!picked_up[r] && lt_last(key_up[r], r, vu, iu)) { vu = key_up[r]; iu = r; }
      if (!picked_lo[r] && gt_last(key_lo[r], r, vl, il)) { vl = key_lo[r]; il = r; }
    }
    warp_pick(vu, iu, vl, il);
    if (lane == 0) {
      wvu[warp] = vu; wiu[warp] = iu;
      wvl[warp] = vl; wil[warp] = il;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < SEL_WARPS; ++w) {
        if (lt_last(wvu[w], wiu[w], vu, iu)) { vu = wvu[w]; iu = wiu[w]; }
        if (gt_last(wvl[w], wil[w], vl, il)) { vl = wvl[w]; il = wil[w]; }
      }
      const size_t o = (size_t)blockIdx.x * k_cand + k;
      up_val[o] = vu;
      up_idx[o] = base + iu;
      low_val[o] = vl;
      low_idx[o] = base + il;
      // iu, il are -1 only if every row was picked, which k_cand <= block rules out
      if (iu >= 0) picked_up[iu] = 1;
      if (il >= 0) picked_lo[il] = 1;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int tpusvm_select_candidates(const float* df, const float* f32_f, const float* alpha,
                                        const int* y_eff, float C, float eps, int n, int block,
                                        int k_cand, float* up_val, int* up_idx, float* low_val,
                                        int* low_idx, cudaStream_t stream) {
  const int nb = (n + block - 1) / block;
  const int smem = block * (2 * (int)sizeof(float) + 2);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        select_candidates_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (nb > 0) {
    select_candidates_kernel<<<nb, SEL_THREADS, smem, stream>>>(
        df, f32_f, alpha, y_eff, C, eps, n, block, k_cand, up_val, up_idx, low_val, low_idx);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpusvm_fused_fupdate_select(const float* X, const float* XB, const float* coef,
                                           const float* sn, const float* snB, float gamma,
                                           int n, int d, int ld, int q, float* scratch,
                                           const float* f32_f,
                                           const float* alpha, const int* y_eff, float C,
                                           float eps, int block, int k_cand, float* df,
                                           float* up_val, int* up_idx, float* low_val,
                                           int* low_idx, cudaStream_t stream) {
  const int rc = tpusvm::launch_rbf_cross_matvec(X, XB, coef, sn, snB, gamma, n, d, ld, q,
                                                 scratch, df, stream);
  if (rc != 0) return rc;
  return tpusvm_select_candidates(df, f32_f, alpha, y_eff, C, eps, n, block, k_cand, up_val,
                                  up_idx, low_val, low_idx, stream);
}
