// Fused 3x3 stride-1 pad-1 convolution with BN prologue and statistics
// epilogue, forward and backward, as implicit matrix products.
//
// Forward (mmr_c3_fwd) replaces the TPU kernel of the JAX package's
// ops/fused_conv_bn.py `_c3_fwd` (body `_c3_kernel`):
//   xhat = relu(x * a + b) in bf16 (optional), zero-padded AFTER the prologue
//   (a border tap contributes 0, not relu(b)); y = bf16(conv3x3(xhat, w));
//   sums = (sum y, sum y^2) of the rounded y.
// Backward (mmr_c3_bwd) replaces `_c3_bwd` (bodies `_c3_bwd_kernel`,
// `_c3_bwd_kernel_plain`):
//   gy_eff = bf16(gy + gs0 + 2 y gs1), zero outside the image (written once
//   to scratch by a small elementwise kernel, as the TPU kernel writes it to
//   its padded VMEM buffer, since all nine taps of dx and dw read it); dxh = the
//   flipped-kernel convolution of gy_eff; dz, dx, da, db as in fused_mm.cu;
//   dw[tap] = sum over pixels of gy_eff(p)^T xhat(p + offset(tap)).
//
// Layout: x, dx (B, H, W, C) and y, gy (B, H, W, Cout) bf16, channels last;
// w9 (9, Cout, C) bf16, the torch (Cout, C, 3, 3) weight permuted to
// (kh, kw, Cout, C); dw9 (9, Cout, C) float32 likewise; ab (2, C), gs and
// sums (2, Cout), dab (2, C) float32. C and Cout are multiples of 8; B, H, W
// are any positive numbers.
//
// Bound on the H100: memory at layer1 (B 48, 56 x 56, C 64: 38.5 MB against
// 11.1 GFLOP, 11.5 us against 11.2 us) and operations from layer2 on. The
// TPU kernel handles whole images per grid step, builds W-shifted copies by
// rolls in VMEM and falls back to XLA when an image tile does not fit. Here
// the conv is an implicit GEMM over M = B*H*W output pixels: a block owns
// 128 consecutive pixels x 64 output channels and walks the 9 taps x C/32
// channel steps, gathering each operand tile from the shifted pixels
// (bounds-checked per row, so image borders, image seams inside a tile and
// the ragged last tile are all the same case); the 9-fold re-read of x comes
// from L1/L2. Any C, Cout, H, W and batch: no capacity fallback. Statistics,
// da/db and dw are per-block partials summed in a fixed order. Not yet: a
// shared-memory halo tile that is loaded (and normalized) once for all nine
// taps, cp.async/TMA pipelining, wgmma.

#include "fused_tiles.cuh"

namespace {

using namespace mmr;

template <bool PRO>
__global__ void __launch_bounds__(kThreads)
c3_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w9,
              const float* __restrict__ ab, bf16* __restrict__ y,
              float* __restrict__ partial, int B, int H, int W, int C, int Cout, int relu) {
  __shared__ __align__(128) unsigned char tile[kStageBytes];
  __shared__ float sRed[8][2][kBN];
  bf16* sA = reinterpret_cast<bf16*>(tile);  // gathered xhat, sA[pixel][c]
  bf16* sB = sA + kBM * kLdA;                // w9[tap] tile as sB[cout][c]
  float* sC = reinterpret_cast<float*>(tile);
  const int M = B * H * W;
  const int ntiles = (Cout + kBN - 1) / kBN;
  const int mt = blockIdx.x / ntiles, nt = blockIdx.x % ntiles;
  const int m0 = mt * kBM, n0 = nt * kBN;
  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
  // this thread gathers chunk kc of rows arow and arow + 64
  const int arow = threadIdx.x / 4, kc = (threadIdx.x % 4) * 8;
  int ph[2], pw[2];
  bool pv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gm = m0 + arow + 64 * i;
    pv[i] = gm < M;
    pw[i] = gm % W;
    ph[i] = (gm / W) % H;
  }
  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    for (int c0 = 0; c0 < C; c0 += kBK) {
      const int gc = c0 + kc;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int hh = ph[i] + dy, ww = pw[i] + dx;
        Chunk v = zero_chunk();
        if (pv[i] && gc < C && hh >= 0 && hh < H && ww >= 0 && ww < W) {
          const long long src = (long long)(m0 + arow + 64 * i) + dy * W + dx;
          v = load_chunk(x + src * C + gc);
          if (PRO) v = prologue_chunk(v, ab, C, gc, relu);
        }
        store_chunk(sA + (arow + 64 * i) * kLdA + kc, v);
      }
      {
        const int gn = n0 + arow;  // 64 rows of couts, same chunk split
        store_chunk(sB + arow * kLdA + kc,
                    (gn < Cout && gc < C)
                        ? load_chunk(w9 + ((long long)tap * Cout + gn) * C + gc)
                        : zero_chunk());
      }
      __syncthreads();
      mma_step<true>(sA, sB, acc, wm, wn);
      __syncthreads();
    }
  }
  stage_tile(sC, acc, wm, wn);
  __syncthreads();
  epilogue_y_stats(sC, sRed, y, partial, mt, m0, n0, M, Cout);
}

// ge = gy_eff, chunk by chunk; chunks = B*H*W*Cout / 8.
__global__ void gy_eff_kernel(const bf16* __restrict__ gy, const bf16* __restrict__ y,
                              const float* __restrict__ gs, bf16* __restrict__ ge,
                              long long chunks, int Cout) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < chunks; i += stride) {
    const long long at = i * 8;
    store_chunk(ge + at, gy_eff_chunk(load_chunk(gy + at), load_chunk(y + at), gs, Cout,
                                      (int)(at % Cout)));
  }
}

template <bool PRO>
__global__ void __launch_bounds__(kThreads)
c3_bwd_dx_kernel(const bf16* __restrict__ ge, const bf16* __restrict__ x,
                 const bf16* __restrict__ w9, const float* __restrict__ ab,
                 bf16* __restrict__ dx, float* __restrict__ partial, int B, int H, int W, int C,
                 int Cout, int relu) {
  __shared__ __align__(128) unsigned char tile[kStageBytes];
  __shared__ float sRed[8][2][kBN];
  bf16* sA = reinterpret_cast<bf16*>(tile);  // gathered gy_eff, sA[pixel][cout]
  bf16* sB = sA + kBM * kLdA;                // w9[tap] tile as sB[cout][c]
  float* sC = reinterpret_cast<float*>(tile);
  const int M = B * H * W;
  const int ctiles = (C + kBN - 1) / kBN;
  const int mt = blockIdx.x / ctiles, ct = blockIdx.x % ctiles;
  const int m0 = mt * kBM, c0 = ct * kBN;
  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
  const int arow = threadIdx.x / 4, oc = (threadIdx.x % 4) * 8;
  const int brow = threadIdx.x / 8, bc = (threadIdx.x % 8) * 8;
  int ph[2], pw[2];
  bool pv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gm = m0 + arow + 64 * i;
    pv[i] = gm < M;
    pw[i] = gm % W;
    ph[i] = (gm / W) % H;
  }
  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int tap = 0; tap < 9; ++tap) {
    // y(p) took xhat(p + (dy, dx)) through w9[tap]: dxh(q) takes gy_eff(q - (dy, dx))
    const int dy = tap / 3 - 1, dx_ = tap % 3 - 1;
    for (int o0 = 0; o0 < Cout; o0 += kBK) {
      const int go = o0 + oc;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int hh = ph[i] - dy, ww = pw[i] - dx_;
        Chunk v = zero_chunk();
        if (pv[i] && go < Cout && hh >= 0 && hh < H && ww >= 0 && ww < W) {
          const long long src = (long long)(m0 + arow + 64 * i) - dy * W - dx_;
          v = load_chunk(ge + src * Cout + go);
        }
        store_chunk(sA + (arow + 64 * i) * kLdA + oc, v);
      }
      {
        const int gob = o0 + brow, gc = c0 + bc;
        store_chunk(sB + brow * kLdB + bc,
                    (gob < Cout && gc < C)
                        ? load_chunk(w9 + ((long long)tap * Cout + gob) * C + gc)
                        : zero_chunk());
      }
      __syncthreads();
      mma_step<false>(sA, sB, acc, wm, wn);
      __syncthreads();
    }
  }
  stage_tile(sC, acc, wm, wn);
  __syncthreads();
  epilogue_dx<PRO>(sC, sRed, x, ab, dx, partial, mt, m0, c0, M, C, relu);
}

// One tap's dw tile (o0.., c0..) over the pixels of one split; out is
// (splits, 9, Cout, C).
template <bool PRO>
__global__ void __launch_bounds__(kThreads)
c3_bwd_dw_kernel(const bf16* __restrict__ ge, const bf16* __restrict__ x,
                 const float* __restrict__ ab, float* __restrict__ out, int B, int H, int W,
                 int C, int Cout, int relu, int rows_per_split) {
  __shared__ __align__(128) unsigned char tile[kDwT * kLdC * 4];
  bf16* sG = reinterpret_cast<bf16*>(tile);  // gy_eff rows, sG[pixel][cout]
  bf16* sX = sG + kDwRows * kLdD;            // shifted xhat rows, sX[pixel][c]
  float* sC = reinterpret_cast<float*>(tile);
  const int M = B * H * W;
  const int otiles = (Cout + kDwT - 1) / kDwT, ctiles = (C + kDwT - 1) / kDwT;
  int b = blockIdx.x;
  const int tap = b % 9;
  b /= 9;
  const int ct = b % ctiles;
  b /= ctiles;
  const int ot = b % otiles, split = b / otiles;
  const int o0 = ot * kDwT, c0 = ct * kDwT;
  const int dy = tap / 3 - 1, dx = tap % 3 - 1;
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
      if (o0 + cc < Cout) g = load_chunk(ge + gm * Cout + o0 + cc);
      const int ww = (int)(gm % W) + dx, hh = (int)((gm / W) % H) + dy;
      if (c0 + cc < C && hh >= 0 && hh < H && ww >= 0 && ww < W) {
        xv = load_chunk(x + (gm + dy * W + dx) * C + c0 + cc);
        if (PRO) xv = prologue_chunk(xv, ab, C, c0 + cc, relu);
      }
    }
    store_chunk(sG + row * kLdD + cc, g);
    store_chunk(sX + row * kLdD + cc, xv);
    __syncthreads();
    dw_mma_step(sG, sX, acc, wn, wk);
    __syncthreads();
  }
  write_dw_tile(sC, acc, wn, wk, out + ((long long)split * 9 + tap) * Cout * C, o0, c0, Cout,
                C);
}

}  // namespace

// x (B, H, W, C), w9 (9, Cout, C) bf16; ab (2, C) float32 or null; y
// (B, H, W, Cout) bf16; partial (ceil(B*H*W / 128), 2, Cout) float32
// scratch; sums (2, Cout) float32. Returns the first CUDA error.
extern "C" int mmr_c3_fwd(const void* x, const void* w9, const void* ab, void* y,
                          void* partial, void* sums, int B, int H, int W, int C, int Cout,
                          int relu, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int M = B * H * W;
  const int mtiles = (M + kBM - 1) / kBM, ntiles = (Cout + kBN - 1) / kBN;
  const unsigned int grid = (unsigned int)mtiles * ntiles;
  if (ab != nullptr) {
    c3_fwd_kernel<true><<<grid, kThreads, 0, st>>>(
        (const bf16*)x, (const bf16*)w9, (const float*)ab, (bf16*)y, (float*)partial, B, H, W,
        C, Cout, relu);
  } else {
    c3_fwd_kernel<false><<<grid, kThreads, 0, st>>>(
        (const bf16*)x, (const bf16*)w9, nullptr, (bf16*)y, (float*)partial, B, H, W, C, Cout,
        0);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_partials((const float*)partial, (float*)sums, mtiles, 2LL * Cout, st);
}

// gy, y (B, H, W, Cout), x (B, H, W, C), w9 (9, Cout, C) bf16; gs (2, Cout)
// float32; ab (2, C) float32 or null. Outputs: dx (B, H, W, C) bf16, dw9
// (9, Cout, C) float32, dab (2, C) float32 (with ab). Scratch: partial_ab
// (ceil(B*H*W / 128), 2, C) float32 (with ab), partial_dw (splits, 9, Cout, C)
// float32 (unused when splits == 1), ge (B, H, W, Cout) bf16 for gy_eff;
// rows_per_split as in mmr_mm_stats_bwd. Returns the first CUDA error.
extern "C" int mmr_c3_bwd(const void* gy, const void* y, const void* x, const void* w9,
                          const void* gs, const void* ab, void* dx, void* dw9, void* dab,
                          void* partial_ab, void* partial_dw, void* ge, int B, int H, int W,
                          int C, int Cout, int relu, int splits, int rows_per_split,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int M = B * H * W;
  const int mtiles = (M + kBM - 1) / kBM, ctiles = (C + kBN - 1) / kBN;
  const unsigned int grid = (unsigned int)mtiles * ctiles;
  const unsigned int dw_grid =
      (unsigned int)splits * 9 * ((Cout + kDwT - 1) / kDwT) * ((C + kDwT - 1) / kDwT);
  float* dw_out = splits == 1 ? (float*)dw9 : (float*)partial_dw;
  const long long chunks = (long long)M * Cout / 8;
  gy_eff_kernel<<<grid_for(chunks, kThreads), kThreads, 0, st>>>(
      (const bf16*)gy, (const bf16*)y, (const float*)gs, (bf16*)ge, chunks, Cout);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (ab != nullptr) {
    c3_bwd_dx_kernel<true><<<grid, kThreads, 0, st>>>(
        (const bf16*)ge, (const bf16*)x, (const bf16*)w9, (const float*)ab, (bf16*)dx,
        (float*)partial_ab, B, H, W, C, Cout, relu);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = reduce_partials((const float*)partial_ab, (float*)dab, mtiles, 2LL * C, st);
    if (err != cudaSuccess) return (int)err;
    c3_bwd_dw_kernel<true><<<dw_grid, kThreads, 0, st>>>(
        (const bf16*)ge, (const bf16*)x, (const float*)ab, dw_out, B, H, W, C, Cout, relu,
        rows_per_split);
  } else {
    c3_bwd_dx_kernel<false><<<grid, kThreads, 0, st>>>(
        (const bf16*)ge, (const bf16*)x, (const bf16*)w9, nullptr, (bf16*)dx, nullptr, B, H, W,
        C, Cout, 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    c3_bwd_dw_kernel<false><<<dw_grid, kThreads, 0, st>>>(
        (const bf16*)ge, (const bf16*)x, nullptr, dw_out, B, H, W, C, Cout, 0, rows_per_split);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (splits > 1) {
    return (int)reduce_partials((const float*)partial_dw, (float*)dw9, splits,
                                9LL * Cout * C, st);
  }
  return 0;
}
