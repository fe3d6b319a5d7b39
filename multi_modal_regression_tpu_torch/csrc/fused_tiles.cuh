// Building blocks shared by the fused conv+BN kernels (fused_mm.cu,
// fused_c3.cu): the chunk moves, the BN prologue and the forward kernels'
// wmma tiles. The backward kernels' pipeline is in sm90_tiles.cuh.
//
// The forward kernels are tensor-core matrix products (nvcuda::wmma, bf16
// operands, float32 accumulation) over shared-memory tiles, with the BN
// prologue applied while a tile is loaded and the epilogue applied to the
// float32 tile before it is written:
//
//   prologue   xhat = relu(bf16(bf16(x * a) + b)), a and b rounded to bf16
//              first: the rounding of torch's eager bf16 ops (and of the JAX
//              kernels), no contracted FMA, so kernel and plain version feed
//              identical bf16 operands to their products
//   gy_eff     bf16((gy + gs0) + (2 * y) * gs1) in float32, rounded once
//              (backward, sm90_tiles.cuh gy_eff8)
//   forward    y = bf16(acc); (sum y, sum y^2) of the ROUNDED y per block
//   backward   dz = dxh masked by the recomputed z > 0; dx = bf16(dz * a);
//              (sum dz * x, sum dz) per block (sm90_tiles.cuh dx_epilogue)
//
// Reductions across blocks are per-block partials in scratch memory that
// the caller allocates, summed in a fixed order (the forward's statistics
// by reduce_partials_kernel): no float atomics, the same bits on every run.
//
// Channel counts (K, N, C, Cout) are multiples of 8: every tile is moved in
// 16-byte chunks of 8 bf16 values, a chunk lying wholly inside or wholly
// outside the matrix. Rows (M) are ragged: rows past M load as zeros and are
// neither written nor counted.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace mmr {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

// Output tile of the forward kernels: 128 rows x 64 columns, reduced
// in steps of 32, by 8 warps of 32 x 32 each.
constexpr int kBM = 128;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;
constexpr int kLdA = kBK + 8;   // bf16 row pitch of a (rows x 32) operand tile
constexpr int kLdC = kBN + 4;   // float row pitch of the staged accumulators
constexpr int kStageBytes = kBM * kLdC * 4;  // 34816: the largest user of the tile memory

struct alignas(16) Chunk {
  bf16 v[8];
};

__device__ __forceinline__ Chunk load_chunk(const bf16* p) {
  return *reinterpret_cast<const Chunk*>(p);
}

__device__ __forceinline__ void store_chunk(bf16* p, const Chunk& c) {
  *reinterpret_cast<Chunk*>(p) = c;
}

__device__ __forceinline__ Chunk zero_chunk() {
  Chunk c;
#pragma unroll
  for (int j = 0; j < 8; ++j) c.v[j] = __float2bfloat16_rn(0.0f);
  return c;
}

// z = bf16(bf16(x * a) + b) as a float; a, b already rounded to bf16.
__device__ __forceinline__ float prologue_z(float x, float a, float b) {
  return round_to<bf16>(__fadd_rn(round_to<bf16>(__fmul_rn(x, a)), b));
}

// The prologue on 8 channels starting at channel k; ab is (2, K) float32.
// Packed bf16 arithmetic: a bf16 product is exact in float32 and a bf16 sum
// cannot land on a rounding boundary that float32 moves, so one rounding to
// bf16 (mul.rn.bf16x2, add.rn.bf16x2; the _rn forms are never contracted
// into an FMA) gives the bits of prologue_z.
__device__ __forceinline__ Chunk prologue_chunk(Chunk c, const float* __restrict__ ab, int K,
                                                int k, int relu) {
  __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(c.v);
  const __nv_bfloat162 zero = __floats2bfloat162_rn(0.0f, 0.0f);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 af = *reinterpret_cast<const float2*>(ab + k + 2 * j);
    const float2 bf = *reinterpret_cast<const float2*>(ab + K + k + 2 * j);
    __nv_bfloat162 z = __hadd2_rn(__hmul2_rn(v[j], __floats2bfloat162_rn(af.x, af.y)),
                                  __floats2bfloat162_rn(bf.x, bf.y));
    if (relu) z = __hmax2_nan(z, zero);  // NaN stays NaN, as torch.relu keeps it
    v[j] = z;
  }
  return c;
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// One reduction step of the 128 x 64 tile: acc += A (128 x 32, sA[row][k])
// times B (32 x 64) held as sB[n][k] (pitch kLdA: the weights (N, K)).
__device__ __forceinline__ void mma_step(const bf16* sA, const bf16* sB, FragC (&acc)[2][2],
                                         int wm, int wn) {
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    FragA a[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      wmma::load_matrix_sync(a[i], sA + (wm * 32 + i * 16) * kLdA + kk, kLdA);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      FragBT b;
      wmma::load_matrix_sync(b, sB + (wn * 32 + j * 16) * kLdA + kk, kLdA);
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
    }
  }
}

// The accumulators of the 128 x 64 tile, staged as floats sC[row][col].
__device__ __forceinline__ void stage_tile(float* sC, FragC (&acc)[2][2], int wm, int wn) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(sC + (wm * 32 + i * 16) * kLdC + wn * 32 + j * 16, acc[i][j],
                              kLdC, wmma::mem_row_major);
    }
  }
}

// Sum the 8 row groups' per-column pairs in order and write the block's
// partial: partial[(mt * 2 + which) * N + n0 + col].
__device__ __forceinline__ void write_block_partial(float (*sRed)[2][kBN], float s0, float s1,
                                                    float q0, float q1, float* partial,
                                                    int mt, int n0, int N) {
  const int cp = threadIdx.x % 32, rg = threadIdx.x / 32;
  sRed[rg][0][2 * cp] = s0;
  sRed[rg][0][2 * cp + 1] = s1;
  sRed[rg][1][2 * cp] = q0;
  sRed[rg][1][2 * cp + 1] = q1;
  __syncthreads();
  if (threadIdx.x < 2 * kBN) {
    const int which = threadIdx.x / kBN, col = threadIdx.x % kBN;
    if (n0 + col < N) {
      float t = 0.0f;
#pragma unroll
      for (int r = 0; r < 8; ++r) t += sRed[r][which][col];
      partial[((long long)mt * 2 + which) * N + n0 + col] = t;
    }
  }
}

// Forward epilogue: y = bf16(sC) for rows < M, columns < N, and the block's
// (sum y, sum y^2) of the rounded values into `partial` (mtiles, 2, N).
__device__ __forceinline__ void epilogue_y_stats(const float* sC, float (*sRed)[2][kBN],
                                                 bf16* __restrict__ y,
                                                 float* __restrict__ partial, int mt, int m0,
                                                 int n0, int M, int N) {
  const int cp = threadIdx.x % 32, rg = threadIdx.x / 32;
  const int gn = n0 + 2 * cp;
  float s0 = 0.0f, s1 = 0.0f, q0 = 0.0f, q1 = 0.0f;
  if (gn < N) {
    for (int r = rg; r < kBM; r += 8) {
      const int gm = m0 + r;
      if (gm >= M) break;
      const float2 v = *reinterpret_cast<const float2*>(sC + r * kLdC + 2 * cp);
      const __nv_bfloat162 yb = __floats2bfloat162_rn(v.x, v.y);
      *reinterpret_cast<__nv_bfloat162*>(y + (long long)gm * N + gn) = yb;
      const float y0 = __low2float(yb), y1 = __high2float(yb);
      s0 += y0;
      s1 += y1;
      q0 += y0 * y0;
      q1 += y1 * y1;
    }
  }
  write_block_partial(sRed, s0, s1, q0, q1, partial, mt, n0, N);
}

// out[i] = sum over j of partial[j * L + i]: 8 interleaved slices of the P
// partials are each summed in order, then the 8 sums in order. (static: the
// header is compiled into each of the two sources.)
static __global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                       float* __restrict__ out, int P, long long L) {
  __shared__ float s[8][32];
  const long long i = (long long)blockIdx.x * 32 + threadIdx.x;
  float acc = 0.0f;
  if (i < L) {
    for (int j = threadIdx.y; j < P; j += 8) acc += partial[(long long)j * L + i];
  }
  s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && i < L) {
    float t = 0.0f;
#pragma unroll
    for (int r = 0; r < 8; ++r) t += s[r][threadIdx.x];
    out[i] = t;
  }
}

static inline cudaError_t reduce_partials(const float* partial, float* out, int P, long long L,
                                   cudaStream_t st) {
  if (L <= 0) return cudaSuccess;
  reduce_partials_kernel<<<(unsigned int)((L + 31) / 32), dim3(32, 8), 0, st>>>(partial, out,
                                                                                P, L);
  return cudaGetLastError();
}

}  // namespace mmr
