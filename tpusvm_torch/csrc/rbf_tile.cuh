// The fused RBF cross matvec's main loop, shared by fused_fupdate.cu (the
// f-update alone) and fused_select.cu (the f-update with candidate
// selection), so that both compute df with the same code and flags, bit for
// bit. The design notes are in fused_fupdate.cu.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace tpusvm {
namespace rbf {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int PAD = 4;  // keeps rows 16-byte aligned, spreads stores over banks
constexpr int THREADS = 256;
constexpr int LOADS = (BM * BK) / THREADS;  // elements of each tile per thread

__global__ void __launch_bounds__(THREADS, 2)
rbf_cross_matvec_kernel(const float* __restrict__ X, const float* __restrict__ XB,
                        const float* __restrict__ coef, const float* __restrict__ sn,
                        const float* __restrict__ snB, float gamma, int n, int d, int q,
                        float* __restrict__ out) {
  __shared__ __align__(16) float As[2][BK][BM + PAD];
  __shared__ __align__(16) float Bs[2][BK][BN + PAD];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx*4..+3 and 64+tx*4..+3 of a tile
  const int ty = tid / 16;  // rows ty*4..+3 and 64+ty*4..+3 of the block
  const int row0 = blockIdx.x * BM;

  float sn_r[8];
  float rowsum[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i / 4) * 64 + ty * 4 + (i % 4);
    sn_r[i] = r < n ? sn[r] : 0.f;
    rowsum[i] = 0.f;
  }

  float ra[LOADS], rb[LOADS];
  auto fetch = [&](int col0, int k0) {
#pragma unroll
    for (int s = 0; s < LOADS; ++s) {
      const int idx = tid + s * THREADS;
      const int r = idx / BK;
      const int gc = k0 + idx % BK;
      const int gr = row0 + r;
      const int gj = col0 + r;
      ra[s] = (gr < n && gc < d) ? X[(size_t)gr * d + gc] : 0.f;
      rb[s] = (gj < q && gc < d) ? XB[(size_t)gj * d + gc] : 0.f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int s = 0; s < LOADS; ++s) {
      const int idx = tid + s * THREADS;
      As[buf][idx % BK][idx / BK] = ra[s];
      Bs[buf][idx % BK][idx / BK] = rb[s];
    }
  };

  for (int col0 = 0; col0 < q; col0 += BN) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    fetch(col0, 0);
    stash(0);
    __syncthreads();
    int buf = 0;
    for (int k0 = 0; k0 < d; k0 += BK) {
      const bool more = k0 + BK < d;
      if (more) fetch(col0, k0 + BK);
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      if (more) stash(buf ^ 1);
      __syncthreads();
      buf ^= 1;
    }

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gj = col0 + (j / 4) * 64 + tx * 4 + (j % 4);
      if (gj < q) {
        const float sb = snB[gj];
        const float cj = coef[gj];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float d2 = (sn_r[i] + sb) - 2.f * acc[i][j];
          d2 = fmaxf(d2, 0.f);  // dot-form cancellation guard
          rowsum[i] += expf(-gamma * d2) * cj;
        }
      }
    }
  }

  // the 16 threads sharing a row group are 16 consecutive lanes of one warp
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float v = rowsum[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    const int r = row0 + (i / 4) * 64 + ty * 4 + (i % 4);
    if (tx == 0 && r < n) out[r] = v;
  }
}

}  // namespace rbf

// out_i = sum_k coef_k exp(-gamma max(0, sn_i + snB_k - 2 x_i.xb_k)), one
// launch on `stream`; returns cudaGetLastError().
inline int launch_rbf_cross_matvec(const float* X, const float* XB, const float* coef,
                                   const float* sn, const float* snB, float gamma, int n, int d,
                                   int q, float* out, cudaStream_t stream) {
  if (n > 0) {
    const dim3 grid((n + rbf::BM - 1) / rbf::BM);
    rbf::rbf_cross_matvec_kernel<<<grid, rbf::THREADS, 0, stream>>>(X, XB, coef, sn, snB, gamma,
                                                                     n, d, q, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tpusvm
