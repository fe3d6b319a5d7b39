// Fused 1x1 convolution (a matrix product) with BN prologue and statistics
// epilogue, forward and backward.
//
// Forward (mmr_mm_stats) replaces the TPU kernel of the JAX package's
// ops/fused_conv_bn.py `_mm_stats` (bodies `_mm_kernel`, `_mm_kernel_plain`):
//   xhat = relu(x * a + b) in bf16 (optional), y = bf16(xhat @ w^T) with
//   float32 accumulation, sums = (sum y, sum y^2) of the rounded y.
// Backward (mmr_mm_stats_bwd) replaces `_mm_stats_bwd` (bodies
// `_mm_bwd_kernel`, `_mm_bwd_kernel_plain`):
//   gy_eff = bf16(gy + gs0 + 2 y gs1); dxh = gy_eff @ w; dz = dxh masked by
//   the recomputed z > 0; dx = bf16(dz * a); dw = gy_eff^T @ xhat (float32);
//   da = sum dz * x, db = sum dz.
//
// Layout: x (M, K), y and gy (M, N) bf16 row-major (a channels-last
// activation viewed flat); w (N, K) bf16, the torch (O, I, 1, 1) weight; dw
// (N, K) float32 in the same layout; ab (2, K), gs and sums (2, N), dab
// (2, K) float32. K and N are multiples of 8; M is any positive number.
//
// Bound on the H100: memory for every ResNet bottleneck shape (x read and y
// written once is 0.5-2.5 bytes per flop-pair; e.g. M 150528, K 64, N 256:
// 96 MB against 4.9 GFLOP). The TPU kernel walks M tiles in order and keeps
// statistics, dw and da/db in scratch across grid steps; here blocks run in
// parallel, so each writes partials that reduce_partials_kernel sums in a
// fixed order. The design: one 128 x 64 output tile per block, the
// reduction dimension tiled by 32 (any K and N, no capacity fallback),
// prologue or gy_eff applied while the operand tile is loaded, epilogue on
// the float32 tile staged in shared memory. Blocks of one M tile are
// neighbours in the grid, so the operand re-read per column tile comes from
// L2. The backward is two kernels: dx (with da, db) over (M tile, K tile),
// and dw over (N tile, K tile, M split), each split summing its rows in
// order. Not yet: cp.async/TMA pipelining, wgmma, wider tiles.

#include "fused_tiles.cuh"

namespace {

using namespace mmr;

// Load the (128 x 32) tile of x at (m0, k0) into sA, prologue applied.
template <bool PRO>
__device__ __forceinline__ void load_x_tile(bf16* sA, const bf16* __restrict__ x,
                                            const float* __restrict__ ab, int m0, int k0, int M,
                                            int K, int relu) {
  for (int c = threadIdx.x; c < kBM * (kBK / 8); c += kThreads) {
    const int row = c / (kBK / 8), kc = (c % (kBK / 8)) * 8;
    const int gm = m0 + row, gk = k0 + kc;
    Chunk v = zero_chunk();
    if (gm < M && gk < K) {
      v = load_chunk(x + (long long)gm * K + gk);
      if (PRO) v = prologue_chunk(v, ab, K, gk, relu);
    }
    store_chunk(sA + row * kLdA + kc, v);
  }
}

template <bool PRO>
__global__ void __launch_bounds__(kThreads)
mm_stats_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const float* __restrict__ ab, bf16* __restrict__ y,
                float* __restrict__ partial, int M, int K, int N, int relu) {
  __shared__ __align__(128) unsigned char tile[kStageBytes];
  __shared__ float sRed[8][2][kBN];
  bf16* sA = reinterpret_cast<bf16*>(tile);
  bf16* sB = sA + kBM * kLdA;  // w tile as sB[n][k]
  float* sC = reinterpret_cast<float*>(tile);
  const int ntiles = (N + kBN - 1) / kBN;
  const int mt = blockIdx.x / ntiles, nt = blockIdx.x % ntiles;
  const int m0 = mt * kBM, n0 = nt * kBN;
  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += kBK) {
    load_x_tile<PRO>(sA, x, ab, m0, k0, M, K, relu);
    {
      const int n = threadIdx.x / 4, kc = (threadIdx.x % 4) * 8;
      const int gn = n0 + n, gk = k0 + kc;
      store_chunk(sB + n * kLdA + kc,
                  (gn < N && gk < K) ? load_chunk(w + (long long)gn * K + gk) : zero_chunk());
    }
    __syncthreads();
    mma_step<true>(sA, sB, acc, wm, wn);
    __syncthreads();
  }
  stage_tile(sC, acc, wm, wn);
  __syncthreads();
  epilogue_y_stats(sC, sRed, y, partial, mt, m0, n0, M, N);
}

template <bool PRO>
__global__ void __launch_bounds__(kThreads)
mm_bwd_dx_kernel(const bf16* __restrict__ gy, const bf16* __restrict__ y,
                 const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const float* __restrict__ gs, const float* __restrict__ ab,
                 bf16* __restrict__ dx, float* __restrict__ partial, int M, int K, int N,
                 int relu) {
  __shared__ __align__(128) unsigned char tile[kStageBytes];
  __shared__ float sRed[8][2][kBN];
  bf16* sA = reinterpret_cast<bf16*>(tile);  // gy_eff tile, sA[m][n]
  bf16* sB = sA + kBM * kLdA;                // w tile as sB[n][k]
  float* sC = reinterpret_cast<float*>(tile);
  const int ktiles = (K + kBN - 1) / kBN;
  const int mt = blockIdx.x / ktiles, kt = blockIdx.x % ktiles;
  const int m0 = mt * kBM, k0 = kt * kBN;
  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int nn0 = 0; nn0 < N; nn0 += kBK) {
    for (int c = threadIdx.x; c < kBM * (kBK / 8); c += kThreads) {
      const int row = c / (kBK / 8), nc = (c % (kBK / 8)) * 8;
      const int gm = m0 + row, gn = nn0 + nc;
      Chunk v = zero_chunk();
      if (gm < M && gn < N) {
        const long long at = (long long)gm * N + gn;
        v = gy_eff_chunk(load_chunk(gy + at), load_chunk(y + at), gs, N, gn);
      }
      store_chunk(sA + row * kLdA + nc, v);
    }
    {
      const int n = threadIdx.x / 8, kc = (threadIdx.x % 8) * 8;
      const int gn = nn0 + n, gk = k0 + kc;
      store_chunk(sB + n * kLdB + kc,
                  (gn < N && gk < K) ? load_chunk(w + (long long)gn * K + gk) : zero_chunk());
    }
    __syncthreads();
    mma_step<false>(sA, sB, acc, wm, wn);
    __syncthreads();
  }
  stage_tile(sC, acc, wm, wn);
  __syncthreads();
  epilogue_dx<PRO>(sC, sRed, x, ab, dx, partial, mt, m0, k0, M, K, relu);
}

// dw tile (n0.., k0..) over the rows of one M split; out is (splits, N, K).
template <bool PRO>
__global__ void __launch_bounds__(kThreads)
mm_bwd_dw_kernel(const bf16* __restrict__ gy, const bf16* __restrict__ y,
                 const bf16* __restrict__ x, const float* __restrict__ gs,
                 const float* __restrict__ ab, float* __restrict__ out, int M, int K, int N,
                 int relu, int rows_per_split) {
  __shared__ __align__(128) unsigned char tile[kDwT * kLdC * 4];
  bf16* sG = reinterpret_cast<bf16*>(tile);  // gy_eff rows, sG[m][n]
  bf16* sX = sG + kDwRows * kLdD;            // xhat rows, sX[m][k]
  float* sC = reinterpret_cast<float*>(tile);
  const int ntiles = (N + kDwT - 1) / kDwT, ktiles = (K + kDwT - 1) / kDwT;
  int b = blockIdx.x;
  const int kt = b % ktiles;
  b /= ktiles;
  const int nt = b % ntiles, split = b / ntiles;
  const int n0 = nt * kDwT, k0 = kt * kDwT;
  const long long m_begin = (long long)split * rows_per_split;
  const long long m_end = m_begin + rows_per_split < M ? m_begin + rows_per_split : M;
  const int warp = threadIdx.x / 32, wn = warp / 2, wk = warp % 2;
  const int row = threadIdx.x / 8, cc = (threadIdx.x % 8) * 8;
  FragC acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);

  for (long long mb = m_begin; mb < m_end; mb += kDwRows) {
    const long long gm = mb + row;
    Chunk g = zero_chunk(), xv = zero_chunk();
    if (gm < m_end) {
      if (n0 + cc < N) {
        const long long at = gm * N + n0 + cc;
        g = gy_eff_chunk(load_chunk(gy + at), load_chunk(y + at), gs, N, n0 + cc);
      }
      if (k0 + cc < K) {
        xv = load_chunk(x + gm * K + k0 + cc);
        if (PRO) xv = prologue_chunk(xv, ab, K, k0 + cc, relu);
      }
    }
    store_chunk(sG + row * kLdD + cc, g);
    store_chunk(sX + row * kLdD + cc, xv);
    __syncthreads();
    dw_mma_step(sG, sX, acc, wn, wk);
    __syncthreads();
  }
  write_dw_tile(sC, acc, wn, wk, out + (long long)split * N * K, n0, k0, N, K);
}

}  // namespace

// x (M, K), w (N, K) bf16; ab (2, K) float32 or null (no prologue); y (M, N)
// bf16; partial (ceil(M / 128), 2, N) float32 scratch; sums (2, N) float32.
// Returns the first CUDA error (0 on success).
extern "C" int mmr_mm_stats(const void* x, const void* w, const void* ab, void* y,
                            void* partial, void* sums, int M, int K, int N, int relu,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int mtiles = (M + kBM - 1) / kBM, ntiles = (N + kBN - 1) / kBN;
  const unsigned int grid = (unsigned int)mtiles * ntiles;
  if (ab != nullptr) {
    mm_stats_kernel<true><<<grid, kThreads, 0, st>>>(
        (const bf16*)x, (const bf16*)w, (const float*)ab, (bf16*)y, (float*)partial, M, K, N,
        relu);
  } else {
    mm_stats_kernel<false><<<grid, kThreads, 0, st>>>(
        (const bf16*)x, (const bf16*)w, nullptr, (bf16*)y, (float*)partial, M, K, N, 0);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_partials((const float*)partial, (float*)sums, mtiles, 2LL * N, st);
}

// gy, y (M, N), x (M, K), w (N, K) bf16; gs (2, N) float32; ab (2, K) float32
// or null. Outputs: dx (M, K) bf16, dw (N, K) float32, dab (2, K) float32
// (with ab). Scratch: partial_ab (ceil(M / 128), 2, K) float32 (with ab),
// partial_dw (splits, N, K) float32 (unused when splits == 1). The dw kernel
// gives each of `splits` blocks per tile `rows_per_split` rows (a multiple
// of 32, splits * rows_per_split >= M). Returns the first CUDA error.
extern "C" int mmr_mm_stats_bwd(const void* gy, const void* y, const void* x, const void* w,
                                const void* gs, const void* ab, void* dx, void* dw, void* dab,
                                void* partial_ab, void* partial_dw, int M, int K, int N,
                                int relu, int splits, int rows_per_split, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int mtiles = (M + kBM - 1) / kBM, ktiles = (K + kBN - 1) / kBN;
  const unsigned int grid = (unsigned int)mtiles * ktiles;
  const unsigned int dw_grid =
      (unsigned int)splits * ((N + kDwT - 1) / kDwT) * ((K + kDwT - 1) / kDwT);
  float* dw_out = splits == 1 ? (float*)dw : (float*)partial_dw;
  if (ab != nullptr) {
    mm_bwd_dx_kernel<true><<<grid, kThreads, 0, st>>>(
        (const bf16*)gy, (const bf16*)y, (const bf16*)x, (const bf16*)w, (const float*)gs,
        (const float*)ab, (bf16*)dx, (float*)partial_ab, M, K, N, relu);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = reduce_partials((const float*)partial_ab, (float*)dab, mtiles, 2LL * K, st);
    if (err != cudaSuccess) return (int)err;
    mm_bwd_dw_kernel<true><<<dw_grid, kThreads, 0, st>>>(
        (const bf16*)gy, (const bf16*)y, (const bf16*)x, (const float*)gs, (const float*)ab,
        dw_out, M, K, N, relu, rows_per_split);
  } else {
    mm_bwd_dx_kernel<false><<<grid, kThreads, 0, st>>>(
        (const bf16*)gy, (const bf16*)y, (const bf16*)x, (const bf16*)w, (const float*)gs,
        nullptr, (bf16*)dx, nullptr, M, K, N, 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    mm_bwd_dw_kernel<false><<<dw_grid, kThreads, 0, st>>>(
        (const bf16*)gy, (const bf16*)y, (const bf16*)x, (const float*)gs, nullptr, dw_out, M,
        K, N, 0, rows_per_split);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (splits > 1) {
    return (int)reduce_partials((const float*)partial_dw, (float*)dw, splits,
                                (long long)N * K, st);
  }
  return 0;
}
