// Building blocks shared by the fused conv+BN kernels (fused_mm.cu,
// fused_c3.cu): the 16-byte chunk moves, the BN prologue and the second
// launch that sums the forward's statistics. The kernels' pipeline (cp.async
// ring, ldmatrix, mma.sync) and their epilogues are in sm90_tiles.cuh.
//
//   prologue   xhat = relu(bf16(bf16(x * a) + b)), a and b rounded to bf16
//              first: the rounding of torch's eager bf16 ops (and of the JAX
//              kernels), no contracted FMA, so kernel and plain version feed
//              identical bf16 operands to their products
//   gy_eff     bf16((gy + gs0) + (2 * y) * gs1) in float32, rounded once
//              (backward, sm90_tiles.cuh gy_eff8)
//   forward    y = bf16(acc); (sum y, sum y^2) of the ROUNDED y per block
//              (sm90_tiles.cuh y_stats_tile)
//   backward   dz = dxh masked by the recomputed z > 0; dx = bf16(dz * a);
//              (sum dz * x, sum dz) per block (sm90_tiles.cuh dx_epilogue)
//
// Reductions across blocks are per-block partials in scratch memory that
// the caller allocates, summed in a fixed order (the forward's statistics
// by reduce_partials_kernel, a split forward's products and statistics by
// split_fixup_kernel): no float atomics, the same bits on every run.
//
// Channel counts (K, N, C, Cout) are multiples of 8: every tile is moved in
// 16-byte chunks of 8 bf16 values, a chunk lying wholly inside or wholly
// outside the matrix. Rows (M) are ragged: rows past M load as zeros and are
// neither written nor counted.
#pragma once

#include "common.cuh"

namespace mmr {

using bf16 = __nv_bfloat16;

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

// Launch 2 of a call whose reduction was split (K of the 1x1, C of the
// 3x3): y (M, N) = bf16(sum of the ksplit float32 products ypart (ksplit,
// M, N), in split order), written in 16-byte chunks, and sums = (sum y,
// sum y^2) of the rounded y; 8 columns (c0 = 8 blockIdx.x) a block of 1024
// threads:
// each thread its rows in order (2 rows' loads in flight at a time), then
// the 32 lanes of a warp by xor shuffles, then the 32 warps in order: the
// same bits on every run.
static __global__ void __launch_bounds__(1024)
split_fixup_kernel(const float* __restrict__ ypart, bf16* __restrict__ y,
                   float* __restrict__ sums, int M, int N, int ksplit) {
  constexpr int kRows = 2;
  __shared__ float sRed[32][2][8];
  const int c0 = 8 * blockIdx.x;
  float s[8], q[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = q[j] = 0.0f;
  for (int r0 = kRows * threadIdx.x; r0 < M; r0 += kRows * 1024) {
    float v[kRows][8];
#pragma unroll
    for (int u = 0; u < kRows; ++u)
#pragma unroll
      for (int j = 0; j < 8; ++j) v[u][j] = 0.0f;
    for (int p = 0; p < ksplit; ++p) {
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        if (r0 + u < M) {
          const float* src = ypart + ((long long)p * M + r0 + u) * N + c0;
          const float4 a = __ldcg(reinterpret_cast<const float4*>(src));
          const float4 b = __ldcg(reinterpret_cast<const float4*>(src + 4));
          const float f[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
          for (int j = 0; j < 8; ++j) v[u][j] += f[j];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (r0 + u >= M) break;
      Chunk out;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        out.v[j] = __float2bfloat16_rn(v[u][j]);
        const float r = __bfloat162float(out.v[j]);
        s[j] += r;
        q[j] += r * r;
      }
      store_chunk(y + (long long)(r0 + u) * N + c0, out);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
      q[j] += __shfl_xor_sync(0xffffffffu, q[j], off);
    }
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sRed[warp][0][j] = s[j];
      sRed[warp][1][j] = q[j];
    }
  }
  __syncthreads();
  if (threadIdx.x < 16) {
    const int which = threadIdx.x / 8, j = threadIdx.x % 8;
    float t = 0.0f;
#pragma unroll
    for (int r = 0; r < 32; ++r) t += sRed[r][which][j];
    sums[which * N + c0 + j] = t;
  }
}

static inline cudaError_t split_fixup(const float* ypart, bf16* y, float* sums, int M, int N,
                                      int ksplit, cudaStream_t st) {
  split_fixup_kernel<<<N / 8, 1024, 0, st>>>(ypart, y, sums, M, N, ksplit);
  return cudaGetLastError();
}

}  // namespace mmr
