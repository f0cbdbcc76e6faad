// Fused RBF cross matvec: out_i = sum_k coef_k exp(-gamma max(0, sn_i + snB_k - 2 x_i.xb_k)).
//
// Replaces the TPU kernel rbf_cross_matvec_pallas
// (tpusvm/ops/pallas/fused_fupdate.py, body _kernel): the blocked SMO
// solver's f-update f += K(X, X_B) @ (dalpha * y_B), with the (n, q) kernel
// slab never written to device memory.
//
// What bounds it on an H100: 2*n*d*q multiply-adds in IEEE f32 on the FMA
// units (no tensor cores, no TF32: the reference runs this contraction at
// full f32). At the solver's shape (n=60000, d=784, q=2048) that is 192.7
// GFLOP against X's 188 MB, so the kernel is compute-bound by ~50x.
//
// Design: each block owns BM=128 rows of X and walks all q columns in
// BN=128 tiles; for each column tile it stages BK=8-wide slices of X and
// X_B (transposed on the load) through shared memory and accumulates an 8x8
// register tile per thread (256 threads), so each shared-memory float4
// feeds 16 FMAs. The next slice is fetched into registers while the current
// one is multiplied (two shared buffers, one barrier per slice). Two blocks
// share an SM (__launch_bounds__(256, 2) caps registers at 128, at the price
// of a few hundred bytes of spills): the extra warps hide the slice loads,
// which measured faster on an H100 than one block at 143 registers. The
// epilogue turns the tile into kernel values and folds coef_k*K into one
// running sum per row, so a block covers all of q: no atomics, a fixed
// summation order, and one (n,) write. The d tail and the n tail are masked
// on the loads (no padded copy of X); the q tail is masked in the epilogue.
// gamma is a runtime argument. wgmma/TMA or 3xTF32 tensor-core variants are
// later work.

#include "rbf_tile.cuh"

extern "C" int tpusvm_rbf_cross_matvec(const float* X, const float* XB, const float* coef,
                                       const float* sn, const float* snB, float gamma, int n,
                                       int d, int q, float* out, cudaStream_t stream) {
  return tpusvm::launch_rbf_cross_matvec(X, XB, coef, sn, snB, gamma, n, d, q, out, stream);
}
