// The fused RBF cross matvec's main loop, shared by fused_fupdate.cu (the
// f-update alone) and fused_select.cu (the f-update with candidate
// selection), so that both compute df with the same code and flags, bit for
// bit.
//
// What bounds it on an H100: the contraction X . X_B^T, 2*n*d*q flops (192.7
// GFLOP at n=60000, d=784, q=2048), run as 3xTF32 on the tensor cores: each
// operand a = hi + lo with hi = tf32(a), lo = tf32(a - hi), and the kernel
// sums lo.hi + hi.lo + hi.hi in f32 accumulators, three times the flops
// at the dense TF32 rate (495 TFLOP/s), so 1.168 ms; the f32-FMA bound of the
// same contraction is 2.876 ms. The reference runs it at Precision.HIGHEST;
// 3xTF32 keeps ~22 of f32's 24 significand bits per product (the lo.lo term
// and lo's own rounding are dropped), far inside the solver's tolerance.
// Next come the L2 reads: every (128-row, 128-column) unit streams its X rows
// and its column tile of X_B's hi and lo parts, 1.2 MB over the full depth,
// 9.0 GB a call at the bench shape.
//
// Design:
//   - persistent blocks of 384 threads, one per SM, walk the work units, a
//     unit being BM=128 rows by BN=128 columns over the full depth in
//     32-wide k slices; warpgroups 0 and 1 consume (64 rows each, one
//     m64n128k8 wgmma tile), warpgroup 2 produces (one thread issues the
//     TMA loads; setmaxnreg moves its registers to the consumers). Units
//     rather than whole row blocks keep the card evenly busy (7,504 units
//     are 56.8 rounds of 132 SMs), and numbering them row block first keeps
//     the few row blocks of X in flight L2-resident, where a block owning
//     its rows would re-read them from device memory for every column tile;
//   - precision: the tensor cores add into their f32 accumulator rounding
//     toward zero, so a dot of nonnegative rows summed over the whole depth
//     in one accumulator drifts low by about half an ulp of the running sum
//     per k step (measured on an H100: kernel values 15x further from f64
//     than IEEE f32's, PERF.md). So each 32-wide slice goes into a fresh
//     accumulator (12 steps on a small sum) and is added to a second one in
//     registers with IEEE adds: 64 + 64 f32 registers a thread, which is
//     what holds a warpgroup to 64 rows;
//   - a 4-stage ring in shared memory (48 KB a stage: the X slice and the
//     hi and lo X_B slices, 128-byte swizzled), filled by TMA with mbarrier
//     completion; a consumer releases a stage once its wgmmas have read it,
//     and the producer runs on into the next unit;
//   - X's split is made in the consumers' registers (wgmma's A operand comes
//     from registers: each k slice is loaded from shared memory, cut into
//     hi and lo with cvt.rna.tf32.f32, and fed to the tensor cores), so the
//     188 MB X is never split in memory; X_B's hi and lo parts (q x d, 6.4
//     MB each at the bench shape) are made once per call by a small split
//     kernel, before the main launch;
//   - TMA's out-of-bounds zero fill covers the n tail, the d tail (d=784 is
//     24.5 slices of 32) and the q tail of the last column tile; TMA needs a
//     row pitch that is a multiple of 16 bytes and a 16-byte aligned base,
//     which the wrapper provides (it pads d to a multiple of 4 with zero
//     columns, and copies a misaligned X);
//   - the epilogue is the reference's: d2 = max(0, (sn_i + snB_k) - 2 dot),
//     exp(-gamma d2) * coef_k summed per row in f32 in a fixed order with
//     no atomics, so results are reproducible: a running sum over a
//     thread's 32 columns of the unit, a shuffle across the four lanes that
//     share a row, one partial per (column tile, row) in memory, and a last
//     launch that adds each row's partials in column-tile order.
//
// The fleet's problem-axis launch (launch_rbf_cross_matvec_batched): B
// problems share X, each with its own X_B (q rows), coefficients, snB and
// gamma. The problem is the outermost index of the work unit (problem, row
// block, column tile); X_B's TF32 split covers the stacked (B * q, d) rows
// in one map, a problem's column tile j reading rows b*q + j*BN on (a tile
// reaching past q reads the next problem's rows, whose columns the
// epilogue drops, as it drops the solo launch's zero fill); each problem
// has its own partials, summed in the solo order. So a problem's output
// equals the solo launch's on its operands bit for bit. The caller stacks
// only the problems that run a subproblem this round. Each problem still
// streams X once; one X pass for all problems is a later design.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is looked up at run time
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tpusvm {
namespace rbf {

constexpr int BM = 128;          // rows of X per unit
constexpr int BN = 128;          // columns of a tile (rows of X_B), the wgmma N
constexpr int BK = 32;           // k slice: one 128-byte swizzled row of f32
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;     // consumer warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int A_BYTES = BM * BK * 4;
constexpr int B_BYTES = BN * BK * 4;
constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;

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

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// round to TF32 (10 explicit significand bits), nearest, ties away from zero
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// shared-memory descriptor of a K-major tile with 128-byte rows, 128-byte
// swizzle: 8-row groups 1024 bytes apart (SBO), LBO unused
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64x128 f32, the wgmma accumulator layout) = a (64x8 tf32, registers)
// . b (128x8 tf32, shared memory, K-major) + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// X_B (rows, d) -> its TF32 hi and lo parts (rows, ld), columns d..ld-1
// zero
__global__ void tf32_split_kernel(const float* __restrict__ XB, int rows, int d, int ld,
                                  float* __restrict__ hi, float* __restrict__ lo) {
  const size_t total = static_cast<size_t>(rows) * ld;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t r = i / ld;
    const int c = static_cast<int>(i % ld);
    const float x = c < d ? XB[r * d + c] : 0.f;
    const uint32_t h = to_tf32(x);
    hi[i] = __uint_as_float(h);
    lo[i] = __uint_as_float(to_tf32(x - __uint_as_float(h)));
  }
}

// One work unit is a (row block, column tile) pair, BM x BN outputs; units are
// numbered row block major, so the blocks running at one time share a few row
// blocks of X (L2-resident) and all of X_B. Each unit writes the per-row
// partial sum of its column tile to partial[j * n + row]. BATCHED: `nprob`
// problems, the problem the outermost index of the unit; problem b's X_B
// rows start at b*q of the maps, its coef, snB at b*q, its gamma is
// gammas[b], its partials at (b * nj + j) * n.
template <bool BATCHED>
__global__ void __launch_bounds__(THREADS, 1)
rbf_cross_matvec_kernel(const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_bhi,
                        const __grid_constant__ CUtensorMap map_blo,
                        const float* __restrict__ coef, const float* __restrict__ sn,
                        const float* __restrict__ snB, float gamma,
                        const float* __restrict__ gammas, int n, int ld, int q, int nprob,
                        float* __restrict__ partial) {
  extern __shared__ unsigned char smem_raw[];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the ring to it
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int nk = (ld + BK - 1) / BK;
  const int nj = (q + BN - 1) / BN;
  const int per_prob = ((n + BM - 1) / BM) * nj;
  const int units = (BATCHED ? nprob : 1) * per_prob;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), CONSUMERS * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: one thread keeps the ring full, unit after unit ---------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == CONSUMERS * 128) {
      int s = 0;
      uint32_t parity = 1;  // the ring starts empty: the first waits pass
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int b = BATCHED ? u / per_prob : 0;
        const int ur = BATCHED ? u % per_prob : u;
        const int row0 = (ur / nj) * BM;
        const int col0 = b * q + (ur % nj) * BN;
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(smem_u32(&empty[s]), parity);
          const uint32_t bar = smem_u32(&full[s]);
          const uint32_t st = smem_u32(smem + s * STAGE_BYTES);
          // out-of-bounds elements are zero-filled and still counted
          mbar_expect_tx(bar, STAGE_BYTES);
          tma_load(st, &map_x, bar, kb * BK, row0);
          tma_load(st + A_BYTES, &map_bhi, bar, kb * BK, col0);
          tma_load(st + A_BYTES + B_BYTES, &map_blo, bar, kb * BK, col0);
          if (++s == STAGES) {
            s = 0;
            parity ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: 3xTF32 wgmma on the arrived slices, then the epilogue ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // row within an 8-row group
  const int t = lane % 4;  // column pair within an 8-column group
  // this thread's rows (unit-relative): wg*64 + warp*16 + g + 8h
  const int rbase = wg * 64 + warp * 16 + g;
  int s = 0;
  uint32_t parity = 0;
  // acc: the tensor cores' sum over one k slice; tot: the slices' sum
  float acc[64], tot[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int b = BATCHED ? u / per_prob : 0;
    const int ur = BATCHED ? u % per_prob : u;
    const int row0 = (ur / nj) * BM;
    const int j = ur % nj;
    const float* coef_b = coef + static_cast<size_t>(b) * q;
    const float* snB_b = snB + static_cast<size_t>(b) * q;
    const float gamma_b = BATCHED ? __ldg(gammas + b) : gamma;
#pragma unroll
    for (int i = 0; i < 64; ++i) tot[i] = 0.f;

    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(smem_u32(&full[s]), parity);
      const unsigned char* st = smem + s * STAGE_BYTES;
      const float* As = reinterpret_cast<const float*>(st);
      // A fragments (m64 k8, tf32): a0 (g, t), a1 (g+8, t), a2 (g, t+4),
      // a3 (g+8, t+4) of the warp's 16 rows; the 16-byte chunk of a
      // swizzled row is stored at chunk ^ (row % 8), and row % 8 == g
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = rbase + 8 * (e & 1);
          const int c = kk * 8 + t + 4 * (e >> 1);
          const float a = As[r * BK + ((((c >> 2) ^ g)) << 2) + (c & 3)];
          ahi[kk][e] = to_tf32(a);
          alo[kk][e] = to_tf32(a - __uint_as_float(ahi[kk][e]));
        }
      const uint64_t dhi = desc_sw128(smem_u32(st + A_BYTES));
      const uint64_t dlo = desc_sw128(smem_u32(st + A_BYTES + B_BYTES));
      fence_regs(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // k step kk is 8 tf32 = 32 bytes into each 128-byte row; the slice's
        // first product overwrites acc
        wgmma_tf32(acc, alo[kk], dhi + 2 * kk, kk > 0);
        wgmma_tf32(acc, ahi[kk], dlo + 2 * kk, 1);
        wgmma_tf32(acc, ahi[kk], dhi + 2 * kk, 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
      if (++s == STAGES) {
        s = 0;
        parity ^= 1;
      }
      // IEEE adds of the slice's sum (see "precision" above)
#pragma unroll
      for (int i = 0; i < 64; ++i) tot[i] += acc[i];
    }

    // epilogue: accumulator element tot[4i + 2h + c] is (row g + 8h, column
    // 8i + 2t + c); a sum per row over the thread's 32 columns, then across
    // the four lanes that share a row
    float sn_r[2], sum[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + rbase + 8 * h;
      sn_r[h] = r < n ? __ldg(sn + r) : 0.f;
      sum[h] = 0.f;
    }
    const int col0 = j * BN;
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int gj = col0 + 8 * i + 2 * t + c;
        if (gj < q) {
          const float sb = __ldg(snB_b + gj);
          const float cj = __ldg(coef_b + gj);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float d2 = (sn_r[h] + sb) - 2.f * tot[4 * i + 2 * h + c];
            d2 = fmaxf(d2, 0.f);  // dot-form cancellation guard
            sum[h] += expf(-gamma_b * d2) * cj;
          }
        }
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = sum[h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      const int r = row0 + rbase + 8 * h;
      if (t == 0 && r < n) partial[(static_cast<size_t>(b) * nj + j) * n + r] = v;
    }
  }
}

// out_r = sum over column tiles j = 0, 1, ... of partial[j * n + r], in that
// order, in f32; for each of nprob problems (partials and out at b * nj * n
// and b * n)
__global__ void sum_partials_kernel(const float* __restrict__ partial, int n, int nj,
                                    float* __restrict__ out, int nprob) {
  const size_t total = static_cast<size_t>(nprob) * n;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t b = i / n;
    const size_t r = i % n;
    const float* pb = partial + b * nj * n;
    float v = 0.f;
    for (int j = 0; j < nj; ++j) v += pb[static_cast<size_t>(j) * n + r];
    out[b * n + r] = v;
  }
}

// ---- host side --------------------------------------------------------------

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda link)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// error codes of the launch functions beyond cudaError_t's
constexpr int ERR_NO_ENCODER = -1000;  // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = -2000;      // ERR_ENCODE - CUresult: encoding refused
constexpr int ERR_LAYOUT = -3000;      // ld % 4 != 0 or a base not 16-byte aligned

// looked up on the first call and kept; static (internal linkage), so each
// library that includes this header keeps its own copy
static EncodeTiledFn encoder() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      return reinterpret_cast<EncodeTiledFn>(p);
    return static_cast<EncodeTiledFn>(nullptr);
  }();
  return fn;
}

// a (rows, cols) row-major f32 matrix, read in (box_rows, BK) tiles
static int encode(CUtensorMap* map, const float* base, int rows, int cols, int box_rows) {
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(float)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(BK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE - static_cast<int>(r);
}

}  // namespace rbf

// out_i = sum_k coef_k exp(-gamma max(0, sn_i + snB_k - 2 x_i.xb_k)), in three
// launches on `stream`: X_B's TF32 split, the main loop over (row block,
// column tile) units, the fixed-order sum of the units' partials. X is (n, ld)
// with ld >= d a multiple of 4 (columns past d zero) and X_B (q, d). scratch
// holds 2 * q * ld + ceil(q / BN) * n floats (X_B's hi and lo parts, then the
// partials); X and scratch need 16-byte aligned bases (TMA). Returns 0, a
// cudaError_t, or one of rbf::ERR_*.
static int launch_rbf_cross_matvec(const float* X, const float* XB, const float* coef,
                                   const float* sn, const float* snB, float gamma, int n, int d,
                                   int ld, int q, float* scratch, float* out,
                                   cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (q <= 0) {
    cudaMemsetAsync(out, 0, static_cast<size_t>(n) * sizeof(float), stream);
    return static_cast<int>(cudaGetLastError());
  }
  if (ld % 4 != 0 || ld < d || reinterpret_cast<uintptr_t>(X) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return rbf::ERR_LAYOUT;
  float* XB_hi = scratch;
  float* XB_lo = XB_hi + static_cast<size_t>(q) * ld;
  float* partial = XB_lo + static_cast<size_t>(q) * ld;
  CUtensorMap map_x, map_bhi, map_blo;
  int rc = rbf::encode(&map_x, X, n, ld, rbf::BM);
  if (rc == 0) rc = rbf::encode(&map_bhi, XB_hi, q, ld, rbf::BN);
  if (rc == 0) rc = rbf::encode(&map_blo, XB_lo, q, ld, rbf::BN);
  if (rc != 0) return rc;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // set on every call: the attribute is held per device
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(rbf::rbf_cross_matvec_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, rbf::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t total = static_cast<size_t>(q) * ld;
  const size_t split_blocks = (total + 255) / 256;
  rbf::tf32_split_kernel<<<static_cast<int>(split_blocks < 4096 ? split_blocks : 4096), 256, 0,
                           stream>>>(XB, q, d, ld, XB_hi, XB_lo);
  // persistent blocks, one per SM, each walking units blockIdx.x + k * grid
  const int nj = (q + rbf::BN - 1) / rbf::BN;
  const int units = ((n + rbf::BM - 1) / rbf::BM) * nj;
  rbf::rbf_cross_matvec_kernel<false>
      <<<units < sms ? units : sms, rbf::THREADS, rbf::SMEM_BYTES, stream>>>(
          map_x, map_bhi, map_blo, coef, sn, snB, gamma, nullptr, n, ld, q, 1, partial);
  const int sum_blocks = (n + 255) / 256;
  rbf::sum_partials_kernel<<<sum_blocks < 1024 ? sum_blocks : 1024, 256, 0, stream>>>(
      partial, n, nj, out, 1);
  return static_cast<int>(cudaGetLastError());
}

// The problem-axis launch: B problems over one X (n, ld), X_B (B * q, d)
// stacked, coef and snB (B * q), gammas (B,), out (B, n). Problem b's out
// row equals launch_rbf_cross_matvec on its slices bit for bit.
// scratch holds 2 * B * q * ld + B * ceil(q / BN) * n floats. Returns as
// launch_rbf_cross_matvec does.
static int launch_rbf_cross_matvec_batched(const float* X, const float* XB, const float* coef,
                                           const float* sn, const float* snB,
                                           const float* gammas, int n, int d,
                                           int ld, int q, int B, float* scratch, float* out,
                                           cudaStream_t stream) {
  if (n <= 0 || q <= 0 || B <= 0) return static_cast<int>(cudaGetLastError());
  if (ld % 4 != 0 || ld < d || reinterpret_cast<uintptr_t>(X) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return rbf::ERR_LAYOUT;
  const size_t rows = static_cast<size_t>(B) * q;
  float* XB_hi = scratch;
  float* XB_lo = XB_hi + rows * ld;
  float* partial = XB_lo + rows * ld;
  CUtensorMap map_x, map_bhi, map_blo;
  int rc = rbf::encode(&map_x, X, n, ld, rbf::BM);
  if (rc == 0) rc = rbf::encode(&map_bhi, XB_hi, static_cast<int>(rows), ld, rbf::BN);
  if (rc == 0) rc = rbf::encode(&map_blo, XB_lo, static_cast<int>(rows), ld, rbf::BN);
  if (rc != 0) return rc;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(rbf::rbf_cross_matvec_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, rbf::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t total = rows * ld;
  const size_t split_blocks = (total + 255) / 256;
  rbf::tf32_split_kernel<<<static_cast<int>(split_blocks < 8192 ? split_blocks : 8192), 256, 0,
                           stream>>>(XB, static_cast<int>(rows), d, ld, XB_hi, XB_lo);
  const int nj = (q + rbf::BN - 1) / rbf::BN;
  const int units = B * ((n + rbf::BM - 1) / rbf::BM) * nj;
  rbf::rbf_cross_matvec_kernel<true>
      <<<units < sms ? units : sms, rbf::THREADS, rbf::SMEM_BYTES, stream>>>(
          map_x, map_bhi, map_blo, coef, sn, snB, 0.f, gammas, n, ld, q, B, partial);
  const size_t sum_total = static_cast<size_t>(B) * n;
  const size_t sum_blocks = (sum_total + 255) / 256;
  rbf::sum_partials_kernel<<<static_cast<int>(sum_blocks < 4096 ? sum_blocks : 4096), 256, 0,
                             stream>>>(partial, n, nj, out, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tpusvm
