// Building blocks shared by the fused conv+BN kernels (fused_mm.cu, fused_c3.cu).
//
// All four kernels are tensor-core matrix products (nvcuda::wmma, bf16
// operands, float32 accumulation) over shared-memory tiles, with the BN
// prologue or the stats cotangent applied while a tile is loaded and the
// epilogue applied to the float32 tile before it is written:
//
//   prologue   xhat = relu(bf16(bf16(x * a) + b)), a and b rounded to bf16
//              first: the rounding of torch's eager bf16 ops (and of the JAX
//              kernels), no contracted FMA, so kernel and plain version feed
//              identical bf16 operands to their products
//   gy_eff     bf16((gy + gs0) + (2 * y) * gs1) in float32, rounded once
//   forward    y = bf16(acc); (sum y, sum y^2) of the ROUNDED y per block
//   backward   dz = dxh masked by the recomputed z > 0; dx = bf16(dz * a);
//              (sum dz * x, sum dz) per block
//
// Reductions across blocks (statistics, da/db, dw) are per-block partials in
// scratch memory that the caller allocates, summed by reduce_partials_kernel
// in a fixed order: no float atomics, the same bits on every run.
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

// Output tile of the forward and dx kernels: 128 rows x 64 columns, reduced
// in steps of 32, by 8 warps of 32 x 32 each.
constexpr int kBM = 128;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;
constexpr int kLdA = kBK + 8;   // bf16 row pitch of a (rows x 32) operand tile
constexpr int kLdB = kBN + 8;   // bf16 row pitch of a (32 x 64) operand tile
constexpr int kLdC = kBN + 4;   // float row pitch of the staged accumulators
constexpr int kStageBytes = kBM * kLdC * 4;  // 34816: the largest user of the tile memory

// dw kernels: a 64 x 64 tile of dw per block, rows consumed 32 at a time.
constexpr int kDwT = 64;
constexpr int kDwRows = 32;
constexpr int kLdD = kDwT + 8;

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

// gy_eff on 8 channels starting at channel n; gs is (2, N) float32.
__device__ __forceinline__ Chunk gy_eff_chunk(const Chunk& gy, const Chunk& y,
                                              const float* __restrict__ gs, int N, int n) {
  Chunk c;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float t = __fmul_rn(__fmul_rn(2.0f, __bfloat162float(y.v[j])), gs[N + n + j]);
    c.v[j] = __float2bfloat16_rn(
        __fadd_rn(__fadd_rn(__bfloat162float(gy.v[j]), gs[n + j]), t));
  }
  return c;
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// One reduction step of the 128 x 64 tile: acc += A (128 x 32, sA[row][k]) times
// B (32 x 64), B held either as sB[n][k] (B_IS_NK, pitch kLdA: the forward's
// weights (N, K)) or as sB[k][n] (pitch kLdB: the dx kernels' weights).
template <bool B_IS_NK>
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
      if (B_IS_NK) {
        FragBT b;
        wmma::load_matrix_sync(b, sB + (wn * 32 + j * 16) * kLdA + kk, kLdA);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      } else {
        FragB b;
        wmma::load_matrix_sync(b, sB + kk * kLdB + wn * 32 + j * 16, kLdB);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
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

// dx epilogue over the staged dxh tile (rows m0.., input channels k0..).
// PRO: the ReLU mask from the recomputed z, dx = bf16(dz * a), and the
// block's (sum dz * x, sum dz) into `partial` (mtiles, 2, K). Otherwise
// dx = bf16(dxh).
template <bool PRO>
__device__ __forceinline__ void epilogue_dx(const float* sC, float (*sRed)[2][kBN],
                                            const bf16* __restrict__ x,
                                            const float* __restrict__ ab,
                                            bf16* __restrict__ dx, float* __restrict__ partial,
                                            int mt, int m0, int k0, int M, int K, int relu) {
  const int cp = threadIdx.x % 32, rg = threadIdx.x / 32;
  const int gk = k0 + 2 * cp;
  float s0 = 0.0f, s1 = 0.0f, q0 = 0.0f, q1 = 0.0f;  // s: sum dz * x, q: sum dz
  if (gk < K) {
    float a0 = 1.0f, a1 = 1.0f, ar0 = 1.0f, ar1 = 1.0f, br0 = 0.0f, br1 = 0.0f;
    if (PRO) {
      a0 = ab[gk];
      a1 = ab[gk + 1];
      ar0 = round_to<bf16>(a0);
      ar1 = round_to<bf16>(a1);
      br0 = round_to<bf16>(ab[K + gk]);
      br1 = round_to<bf16>(ab[K + gk + 1]);
    }
    for (int r = rg; r < kBM; r += 8) {
      const int gm = m0 + r;
      if (gm >= M) break;
      const float2 v = *reinterpret_cast<const float2*>(sC + r * kLdC + 2 * cp);
      float d0 = v.x, d1 = v.y;
      if (PRO) {
        const __nv_bfloat162 xb =
            *reinterpret_cast<const __nv_bfloat162*>(x + (long long)gm * K + gk);
        const float x0 = __low2float(xb), x1 = __high2float(xb);
        if (relu) {
          if (!(prologue_z(x0, ar0, br0) > 0.0f)) d0 = 0.0f;
          if (!(prologue_z(x1, ar1, br1) > 0.0f)) d1 = 0.0f;
        }
        s0 += d0 * x0;
        s1 += d1 * x1;
        q0 += d0;
        q1 += d1;
        d0 = __fmul_rn(d0, a0);
        d1 = __fmul_rn(d1, a1);
      }
      *reinterpret_cast<__nv_bfloat162*>(dx + (long long)gm * K + gk) =
          __floats2bfloat162_rn(d0, d1);
    }
  }
  if (PRO) write_block_partial(sRed, s0, s1, q0, q1, partial, mt, k0, K);
}

// One 32-row step of a dw tile: acc += G^T (sG[m][n], 32 x 64) times
// X (sX[m][k], 32 x 64); 8 warps, warp (wn, wk) owns rows wn*16.., columns wk*32...
__device__ __forceinline__ void dw_mma_step(const bf16* sG, const bf16* sX, FragC (&acc)[2],
                                            int wn, int wk) {
#pragma unroll
  for (int mm = 0; mm < kDwRows; mm += 16) {
    FragAT a;
    wmma::load_matrix_sync(a, sG + mm * kLdD + wn * 16, kLdD);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      FragB b;
      wmma::load_matrix_sync(b, sX + mm * kLdD + wk * 32 + j * 16, kLdD);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
}

// Write a block's 64 x 64 dw tile (staged through sC, pitch kLdC) to
// out[(n0 + n) * K + k0 + k] for n0 + n < N, k0 + k < K.
__device__ __forceinline__ void write_dw_tile(float* sC, FragC (&acc)[2], int wn, int wk,
                                              float* __restrict__ out, int n0, int k0, int N,
                                              int K) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    wmma::store_matrix_sync(sC + (wn * 16) * kLdC + wk * 32 + j * 16, acc[j], kLdC,
                            wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kDwT * kDwT; i += kThreads) {
    const int n = i / kDwT, k = i % kDwT;
    if (n0 + n < N && k0 + k < K) out[(long long)(n0 + n) * K + k0 + k] = sC[n * kLdC + k];
  }
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
