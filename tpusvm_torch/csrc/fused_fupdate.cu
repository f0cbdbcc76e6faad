// Fused RBF cross matvec: out_i = sum_k coef_k exp(-gamma max(0, sn_i + snB_k - 2 x_i.xb_k)).
//
// Replaces the TPU kernel rbf_cross_matvec_pallas
// (tpusvm/ops/pallas/fused_fupdate.py, body _kernel): the blocked SMO
// solver's f-update f += K(X, X_B) @ (dalpha * y_B), with the (n, q) kernel
// slab never written to device memory.
//
// What bounds it on an H100: the contraction, 2*n*d*q flops (192.7 GFLOP at
// n=60000, d=784, q=2048), run as 3xTF32 on the tensor cores: three TF32
// products at 495 TFLOP/s, 1.168 ms (the f32-FMA bound is 2.876 ms); then
// the L2 reads of the chosen unit, 9.0 GB a call (each 128x128 unit streams
// its X rows and its tile of X_B's hi and lo parts), 5.3 TB/s at 1.7 ms.
// X's 188 MB from device memory are nothing next to either, once the units
// in flight share their rows of X in L2.
//
// Design (csrc/rbf_tile.cuh): persistent blocks, one per SM, walk
// (row block, column tile) units; a TMA-fed 4-stage shared-memory ring, one
// producer warpgroup and two consumer warpgroups running wgmma
// m64n128k8 tf32 with X's hi/lo split made in registers, each 32-wide k
// slice summed in a fresh accumulator and added to the unit's total with
// IEEE adds (the tensor cores' own adder rounds toward zero); the exp and
// coefficient epilogue sums each unit's row in a fixed order into a partial.
// Three launches on one stream: X_B's TF32 split, the main loop, the
// fixed-order sum of the partials.

#include "rbf_tile.cuh"

extern "C" int tpusvm_rbf_cross_matvec(const float* X, const float* XB, const float* coef,
                                       const float* sn, const float* snB, float gamma, int n,
                                       int d, int ld, int q, float* scratch, float* out,
                                       cudaStream_t stream) {
  return tpusvm::launch_rbf_cross_matvec(X, XB, coef, sn, snB, gamma, n, d, ld, q, scratch, out,
                                         stream);
}

// The fleet's problem-axis launch: B problems over one X, X_B (B*q, d), coef
// and snB (B*q), gammas (B,), out (B, n); problem b's row of out equals
// tpusvm_rbf_cross_matvec on its slices bit for bit.
extern "C" int tpusvm_rbf_cross_matvec_batched(const float* X, const float* XB,
                                               const float* coef, const float* sn,
                                               const float* snB, const float* gammas,
                                               int n, int d, int ld, int q,
                                               int B, float* scratch, float* out,
                                               cudaStream_t stream) {
  return tpusvm::launch_rbf_cross_matvec_batched(X, XB, coef, sn, snB, gammas, n, d, ld, q, B,
                                                 scratch, out, stream);
}
