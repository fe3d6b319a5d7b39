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
//   gy_eff = bf16(gy + gs0 + 2 y gs1), zero outside the image; dxh = the
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
// 11.1 GFLOP forward) and operations from layer2 on. The TPU kernel handles
// whole images per grid step and builds W-shifted copies by rolls in VMEM.
//
// Forward design: an implicit GEMM over M = B*H*W output pixels; a block
// owns 128 consecutive pixels x 64 output channels and walks the 9 taps x
// C/32 channel steps, gathering each operand tile from the shifted pixels
// (bounds-checked per row, so borders, image seams inside a tile and the
// ragged last tile are one case). Not yet: a halo tile, pipelining, wgmma.
//
// Backward design: two launches on the building blocks of sm90_tiles.cuh
// (3-stage cp.async ring, ldmatrix, mma.sync m16n8k16). Every tap reads its
// operand rows from ONE halo tile in shared memory through per-lane
// ldmatrix row addresses: the pixel p + dy W + dx of a flattened
// (B*H*W) index is that tap's neighbour whenever it lies inside the image,
// and a lane whose neighbour lies outside (border, image seam, ragged end)
// points at a row of zeros, which is the zero padding after the prologue.
//   1. c3_bwd_dw_kernel: a block owns one row of 3 taps (dy) of a 64 x 64
//      (Cout, C) tile over a split of the pixels, in steps of 64 pixels:
//      gy_eff of the 64 pixels and xhat of the 66-pixel window p + dy W - 1
//      .. are formed once in the ring slot, and the 3 taps' products share
//      the gy_eff fragments; each pixel's taps inside the image are worked
//      out once per step into a byte mask. The centre-row blocks of the
//      first C tile write gy_eff to scratch (bf16), so launch 2 never reads
//      gy and y. dw per split is a partial, or dw itself with one split;
//      block 0 zeroes launch 2's counters.
//   2. c3_bwd_dx_kernel: a block owns BM (128 or 64) pixels x 64 input
//      channels and walks Cout in chunks of 16; per chunk one halo of
//      gy_eff (rows m0 - W - 1 .. m0 + BM + W, or, where 2 W + 2 exceeds
//      2 (BM + 2), three segments of BM + 2 rows around m0 - W, m0, m0 + W)
//      and the chunk's 9 weight tiles are loaded once and feed all 9 taps:
//      a 144-deep reduction step. The epilogue is fused_mm.cu's (mask, dx,
//      da, db partial, fixed-order two-level da, db sums); then every block
//      sums its share of launch 1's dw partials in a fixed order.
// Per block (ptxas -v, sm_90a; registers with / without the prologue):
// c3_bwd_dw_kernel 256 threads, 84,144 B of shared memory, 128 / 125
// registers; c3_bwd_dx_kernel 256 threads, BM 128: 116 / 114 registers,
// BM 64: 80 / 74, shared memory 2 x (3 x (24 x halo + 10,368) + 24) bytes
// for a halo of `halo` rows: 97,104 B at 56 x 56 (BM 128), 89,040 at 28 x 28,
// 85,008 at 14 x 14, 73,776 at 7 x 7 (BM 64); two blocks an SM. No spills;
// above 48 KB the kernels need cudaFuncSetAttribute: set once per kernel
// and device (sm90::allow_smem), its error and every launch's checked.
// Bytes from device memory, at least: 8 M Cout + 6 M C (launch 1 reads gy,
// y, x and writes gy_eff; launch 2 reads gy_eff, x, writes dx), M 150528,
// C = Cout = 64: 135 MB, 0.040 ms, against 4 M Cout + 4 M C for the bound;
// halo overlap and re-reads by other C tiles come from L2.
// Not yet: all 9 taps of dw from one halo per block (gy_eff formed once
// instead of 3 C / 64 times), wgmma, TMA.

#include "sm90_tiles.cuh"

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
      mma_step(sA, sB, acc, wm, wn);
      __syncthreads();
    }
  }
  stage_tile(sC, acc, wm, wn);
  __syncthreads();
  epilogue_y_stats(sC, sRed, y, partial, mt, m0, n0, M, Cout);
}

// ---- backward ---------------------------------------------------------------

using namespace mmr::sm90;

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

constexpr int kLd64 = 72;  // pitch of a 64-channel tile
constexpr int kChunk = 16;             // output channels of one dx ring step
constexpr int kLdH = kChunk + 8;       // pitch of the dx kernel's halo tile
constexpr int kPix = 64;   // pixels of one dw ring step
constexpr int kDwThreads = 256;
constexpr int kDwStage = (2 * kPix + kPix + 2) * kLd64;  // gy (-> gy_eff), y, x window
// + a row of zeros and, per stage, each pixel's mask of the taps inside the image
constexpr int kDwSmem = (kStages * kDwStage + kLd64) * 2 + kStages * kPix;

// One row of taps (dy) of the (o0.., c0..) 64 x 64 dw tile over the pixels
// of one split; out is (splits, 9, Cout, C), or dw9 with one split. 8
// warps, 32 (Cout) x 16 (C) each, 3 taps.
template <bool PRO>
__global__ void __launch_bounds__(kDwThreads)
c3_bwd_dw_kernel(const bf16* __restrict__ gy, const bf16* __restrict__ y,
                 const bf16* __restrict__ x, const float* __restrict__ gs,
                 const float* __restrict__ ab, bf16* __restrict__ ge, float* __restrict__ out,
                 unsigned* __restrict__ cnt, int ncnt, int H, int W, int C, int Cout, int M,
                 int relu, int rows_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* zrow = ring + kStages * kDwStage;
  unsigned char* taps = reinterpret_cast<unsigned char*>(zrow + kLd64);  // kStages x kPix
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < ncnt; i += kDwThreads) cnt[i] = 0u;
  }
  if (threadIdx.x < kLd64 / 8) store_chunk(zrow + 8 * threadIdx.x, zero_chunk());
  const int ctiles = cdiv(C, 64), otiles = cdiv(Cout, 64);
  int b = blockIdx.x;
  const int dy = b % 3 - 1;
  b /= 3;
  const int ct = b % ctiles;
  b /= ctiles;
  const int ot = b % otiles, split = b / otiles;
  const int o0 = ot * 64, c0 = ct * 64;
  const int p_begin = split * rows_per_split;
  const int p_end = min(p_begin + rows_per_split, M);
  const int nsteps = cdiv(p_end - p_begin, kPix);
  const bool write_ge = dy == 0 && ct == 0;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, wa = warp / 4, wb = warp % 4;
  // every chunk of this thread lies in channels 8 (threadIdx.x % 8)..
  const Gs8 gsc = load_gs8(gs, Cout, o0 + (threadIdx.x % 8) * 8);
  const Ab8 abc = load_ab8(PRO ? ab : nullptr, C, c0 + (threadIdx.x % 8) * 8);

  auto load = [&](int s, int pb) {
    bf16* sG = ring + s * kDwStage;
    bf16* sY = sG + kPix * kLd64;
    bf16* sX = sY + kPix * kLd64;
#pragma unroll
    for (int u = 0; u < kPix * 8 / kDwThreads; ++u) {
      const int c = threadIdx.x + kDwThreads * u, row = c / 8, cc = (c % 8) * 8;
      const int p = pb + row;
      const bool v = p < p_end && o0 + cc < Cout;
      const long long at = v ? (long long)p * Cout + o0 + cc : 0;
      cp_async16(sG + row * kLd64 + cc, gy + at, v);
      cp_async16(sY + row * kLd64 + cc, y + at, v);
    }
    for (int c = threadIdx.x; c < (kPix + 2) * 8; c += kDwThreads) {
      const int row = c / 8, cc = (c % 8) * 8, q = pb + dy * W - 1 + row;
      const bool v = q >= 0 && q < M && c0 + cc < C;
      cp_async16(sX + row * kLd64 + cc, x + (v ? (long long)q * C + c0 + cc : 0), v);
    }
  };
  auto transform = [&](int s, int pb) {
    bf16* sG = ring + s * kDwStage;
    const bf16* sY = sG + kPix * kLd64;
    bf16* sX = sG + 2 * kPix * kLd64;
#pragma unroll
    for (int u = 0; u < kPix * 8 / kDwThreads; ++u) {
      const int c = threadIdx.x + kDwThreads * u, row = c / 8, cc = (c % 8) * 8;
      const int p = pb + row;
      Chunk g = zero_chunk();
      if (p < p_end && o0 + cc < Cout) {
        g = gy_eff8(load_chunk(sG + row * kLd64 + cc), load_chunk(sY + row * kLd64 + cc), gsc);
        if (write_ge) store_chunk(ge + (long long)p * Cout + o0 + cc, g);
      }
      store_chunk(sG + row * kLd64 + cc, g);
    }
    for (int c = threadIdx.x; c < (kPix + 2) * 8; c += kDwThreads) {
      const int row = c / 8, cc = (c % 8) * 8, q = pb + dy * W - 1 + row;
      Chunk xv = zero_chunk();
      if (q >= 0 && q < M && c0 + cc < C) {
        xv = load_chunk(sX + row * kLd64 + cc);
        if (PRO) xv = prologue8(xv, abc, relu);
      }
      store_chunk(sX + row * kLd64 + cc, xv);
    }
    // bit d of pixel pb + t: its neighbour p + dy W + d - 1 lies in the image
    if (threadIdx.x < kPix) {
      const int p = pb + threadIdx.x, hq = (p / W) % H + dy, wq = p % W;
      unsigned m = 0u;
      if (p < p_end && hq >= 0 && hq < H) {
        m = (wq > 0 ? 1u : 0u) | 2u | (wq + 1 < W ? 4u : 0u);
      }
      taps[s * kPix + threadIdx.x] = (unsigned char)m;
    }
  };

  float acc[3][2][2][4];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[d][i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) load(s, p_begin + s * kPix);
    cp_async_commit();
  }
  for (int it = 0; it < nsteps; ++it) {
    cp_async_wait<kStages - 2>();
    const int s = it % kStages, pb = p_begin + it * kPix;
    transform(s, pb);
    __syncthreads();
    const int nx = it + kStages - 1;
    if (nx < nsteps) load(nx % kStages, p_begin + nx * kPix);
    cp_async_commit();
    const bf16* sG = ring + s * kDwStage;
    const bf16* sX = sG + 2 * kPix * kLd64;
#pragma unroll
    for (int kk = 0; kk < kPix; kk += 16) {
      unsigned a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // A = gy_eff^T: rows Cout, reduction over pixels
        ldsm_x4_t(a[i], sG + (kk + at_row(lane)) * kLd64 + wa * 32 + i * 16 + at_col(lane));
      }
      // this lane's B row: pixel pb + r; its neighbour p + dy W + d - 1
      // sits at window row r + d when it lies inside the image
      const int r = kk + bt_row(lane);
      const unsigned m = taps[s * kPix + r];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const bf16* row = (m >> d) & 1u ? sX + (r + d) * kLd64 : zrow;
        unsigned rr[4];
        ldsm_x4_t(rr, row + wb * 16 + bt_col(lane));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma16816(acc[d][i][0], a[i], rr[0], rr[1]);
          mma16816(acc[d][i][1], a[i], rr[2], rr[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float* o = out + ((long long)split * 9 + (dy + 1) * 3 + d) * Cout * C;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = o0 + wa * 32 + i * 16 + g, k = c0 + wb * 16 + j * 8 + 2 * t;
        if (k >= C) continue;
        if (n < Cout) {
          *reinterpret_cast<float2*>(o + (long long)n * C + k) =
              make_float2(acc[d][i][j][0], acc[d][i][j][1]);
        }
        if (n + 8 < Cout) {
          *reinterpret_cast<float2*>(o + (long long)(n + 8) * C + k) =
              make_float2(acc[d][i][j][2], acc[d][i][j][3]);
        }
      }
    }
  }
}

// Shared memory of the dx kernel: the ring (per stage the gy_eff halo of
// halo_rows x 32 channels and the 9 taps' 32 x 64 weight tiles) and a row of
// zeros; the epilogue (BM x 68 staged floats, 4096 row-group sums, 8 x 128
// floats for the dw partials' sums) reuses it.
inline int c3_dx_smem(int bm, int halo_rows) {
  const int ring = (kStages * (halo_rows * kLdH + 9 * kChunk * kLd64) + kLdH) * 2;
  const int epi = (bm * 68 + 4096 + 1024) * 4;
  return ring > epi ? ring : epi;
}

// BM = 64 MI pixels x 64 input channels of dx; 8 warps as 4 (pixels) x 2
// (channels), each (16 MI) x 32. The halo holds nseg segments of seg_rows
// rows: with one segment, row j is pixel m0 - W - 1 + j; with three, row
// s seg_rows + t is pixel m0 + (s - 1) W - 1 + t. With splits > 1 every
// block then sums its share of launch 1's dw partials.
template <bool PRO, int MI>
__global__ void __launch_bounds__(256)
c3_bwd_dx_kernel(const bf16* __restrict__ ge, const bf16* __restrict__ x,
                 const bf16* __restrict__ w9, const float* __restrict__ ab,
                 bf16* __restrict__ dx, float* __restrict__ part_ab, float* __restrict__ gsum_ab,
                 float* __restrict__ dab, unsigned* __restrict__ cnt,
                 const float* __restrict__ part_dw, float* __restrict__ dw9, int H, int W,
                 int C, int Cout, int M, int relu, int splits, int seg_rows, int nseg) {
  constexpr int BM = 64 * MI;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int halo = nseg * seg_rows, kA = halo * kLdH, kStage = kA + 9 * kChunk * kLd64;
  bf16* zrow = ring + kStages * kStage;
  if (threadIdx.x < kLdH / 8) store_chunk(zrow + 8 * threadIdx.x, zero_chunk());
  const int ctiles = cdiv(C, 64), mtiles = cdiv(M, BM);
  const int mt = blockIdx.x / ctiles, ct = blockIdx.x % ctiles;
  const int m0 = mt * BM, c0 = ct * 64;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
  // this lane's A rows (one per m16 tile) and the taps whose source lies
  // inside the image: dxh(q) takes gy_eff(q - (dy, dx)) through w9[tap]
  int arow[MI];
  unsigned amask[MI];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    arow[i] = wm * 16 * MI + i * 16 + a_row(lane);
    const int q = m0 + arow[i], hq = (q / W) % H, wq = q % W;
    amask[i] = 0u;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int sy = 1 - tap / 3, sx = 1 - tap % 3;
      if (q < M && hq + sy >= 0 && hq + sy < H && wq + sx >= 0 && wq + sx < W) {
        amask[i] |= 1u << tap;
      }
    }
  }

  auto load = [&](int s, int o0) {
    bf16* sA = ring + s * kStage;
    bf16* sB = sA + kA;
    for (int c = threadIdx.x; c < halo * (kChunk / 8); c += 256) {
      const int j = c / (kChunk / 8), cc = (c % (kChunk / 8)) * 8;
      const int q = nseg == 1 ? m0 - (W + 1) + j : m0 + (j / seg_rows - 1) * W - 1 + j % seg_rows;
      const bool v = q >= 0 && q < M && o0 + cc < Cout;
      cp_async16(sA + j * kLdH + cc, ge + (v ? (long long)q * Cout + o0 + cc : 0), v);
    }
    for (int c = threadIdx.x; c < 9 * kChunk * 8; c += 256) {
      const int tap = c / (kChunk * 8), row = (c % (kChunk * 8)) / 8, cc = (c % 8) * 8;
      const bool v = o0 + row < Cout && c0 + cc < C;
      cp_async16(sB + (tap * kChunk + row) * kLd64 + cc,
                 w9 + (v ? ((long long)tap * Cout + o0 + row) * C + c0 + cc : 0), v);
    }
  };

  float acc[MI][4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int nsteps = cdiv(Cout, kChunk);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) load(s, s * kChunk);
    cp_async_commit();
  }
  for (int it = 0; it < nsteps; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nx = it + kStages - 1;
    if (nx < nsteps) load(nx % kStages, nx * kChunk);
    cp_async_commit();
    const bf16* sA = ring + (it % kStages) * kStage;
    const bf16* sB = sA + kA;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int sy = 1 - tap / 3, sx = 1 - tap % 3;
      // halo row of the source pixel q + sy W + sx: seg + (q - m0) + sx
      const int seg = nseg == 1 ? (W + 1) + sy * W : (sy + 1) * seg_rows + 1;
      const bf16* rows[MI];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        rows[i] = (amask[i] >> tap) & 1u ? sA + (seg + arow[i] + sx) * kLdH : zrow;
      }
#pragma unroll
      for (int kk = 0; kk < kChunk; kk += 16) {
        unsigned a[MI][4];
#pragma unroll
        for (int i = 0; i < MI; ++i) ldsm_x4(a[i], rows[i] + kk + a_col(lane));
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          unsigned r[4];
          ldsm_x4_t(r, sB + (tap * kChunk + kk + bt_row(lane)) * kLd64 + wn * 32 + jj * 16 +
                           bt_col(lane));
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            mma16816(acc[i][2 * jj], a[i], r[0], r[1]);
            mma16816(acc[i][2 * jj + 1], a[i], r[2], r[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float* sC = reinterpret_cast<float*>(smem);
  float* sRed = sC + BM * 68;
  stage_acc<MI, 4>(sC, 68, acc, wm * 16 * MI, wn * 32);
  __syncthreads();
  dx_epilogue<PRO, BM, 64>(sC, sRed, x, ab, dx, part_ab, mt, m0, c0, M, C, relu);
  if (splits > 1) reduce_dw_share(part_dw, dw9, splits, 9LL * Cout * C, sRed + 4096);
  if (PRO) {
    const int ngroups = cdiv(mtiles, kGroup);
    reduce_dab_tail(part_ab, gsum_ab, dab, cnt + ct * (ngroups + 1), mtiles, mt, C, c0,
                    min(64, C - c0));
  }
}

template <bool PRO>
cudaError_t launch_c3_bwd(cudaStream_t st, const bf16* gy, const bf16* y, const bf16* x,
                          const bf16* w9, const float* gs, const float* ab, bf16* dx,
                          float* dw9, float* dab, bf16* ge, float* part_dw, float* part_ab,
                          float* gsum_ab, unsigned* cnt, int B, int H, int W, int C, int Cout,
                          int relu, int splits, int rows_per_split, int bm, int nseg,
                          int seg_rows) {
  const int M = B * H * W;
  const int halo = nseg * seg_rows;
  if ((bm != 64 && bm != 128) || splits < 1 || (long long)splits * rows_per_split < M ||
      rows_per_split % kPix != 0 || !((nseg == 1 && seg_rows == bm + 2 * W + 2) ||
                                      (nseg == 3 && seg_rows == bm + 2))) {
    return cudaErrorInvalidValue;
  }
  const int mtiles = (M + bm - 1) / bm, ctiles = (C + 63) / 64;
  const int ncnt = PRO ? ctiles * ((mtiles + kGroup - 1) / kGroup + 1) : 0;
  const unsigned int dw_grid = (unsigned int)splits * 3 * ((Cout + 63) / 64) * ctiles;
  cudaError_t err = allow_smem(c3_bwd_dw_kernel<PRO>, kDwSmem);
  if (err != cudaSuccess) return err;
  c3_bwd_dw_kernel<PRO><<<dw_grid, kDwThreads, kDwSmem, st>>>(
      gy, y, x, gs, ab, ge, splits == 1 ? dw9 : part_dw, cnt, ncnt, H, W, C, Cout, M, relu,
      rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned int grid = (unsigned int)mtiles * ctiles;
  const int smem = c3_dx_smem(bm, halo);
  if (bm == 128) {
    err = allow_smem(c3_bwd_dx_kernel<PRO, 2>, smem);
    if (err != cudaSuccess) return err;
    c3_bwd_dx_kernel<PRO, 2><<<grid, 256, smem, st>>>(ge, x, w9, ab, dx, part_ab, gsum_ab, dab,
                                                      cnt, part_dw, dw9, H, W, C, Cout, M,
                                                      relu, splits, seg_rows, nseg);
  } else {
    err = allow_smem(c3_bwd_dx_kernel<PRO, 1>, smem);
    if (err != cudaSuccess) return err;
    c3_bwd_dx_kernel<PRO, 1><<<grid, 256, smem, st>>>(ge, x, w9, ab, dx, part_ab, gsum_ab, dab,
                                                      cnt, part_dw, dw9, H, W, C, Cout, M,
                                                      relu, splits, seg_rows, nseg);
  }
  return cudaGetLastError();
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
// (9, Cout, C) float32, dab (2, C) float32 (with ab). Scratch: ge (B, H, W,
// Cout) bf16 for gy_eff; part_dw (splits, 9, Cout, C) float32 (unused when
// splits == 1); with ab, part_ab, gsum_ab and cnt as in mmr_mm_stats_bwd
// over ceil(B*H*W / bm) tiles of 64 channels. rows_per_split: pixels per dw
// split, a multiple of 64; bm in {64, 128}; the halo is nseg == 1 segment of
// bm + 2 W + 2 rows or nseg == 3 of bm + 2 (seg_rows). Two launches.
// Returns the first CUDA error.
extern "C" int mmr_c3_bwd(const void* gy, const void* y, const void* x, const void* w9,
                          const void* gs, const void* ab, void* dx, void* dw9, void* dab,
                          void* ge, void* part_dw, void* part_ab, void* gsum_ab, void* cnt,
                          int B, int H, int W, int C, int Cout, int relu, int splits,
                          int rows_per_split, int bm, int nseg, int seg_rows, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (ab != nullptr) {
    err = launch_c3_bwd<true>(st, (const bf16*)gy, (const bf16*)y, (const bf16*)x,
                              (const bf16*)w9, (const float*)gs, (const float*)ab, (bf16*)dx,
                              (float*)dw9, (float*)dab, (bf16*)ge, (float*)part_dw,
                              (float*)part_ab, (float*)gsum_ab, (unsigned*)cnt, B, H, W, C,
                              Cout, relu, splits, rows_per_split, bm, nseg, seg_rows);
  } else {
    err = launch_c3_bwd<false>(st, (const bf16*)gy, (const bf16*)y, (const bf16*)x,
                               (const bf16*)w9, (const float*)gs, nullptr, (bf16*)dx,
                               (float*)dw9, nullptr, (bf16*)ge, (float*)part_dw, nullptr,
                               nullptr, nullptr, B, H, W, C, Cout, 0, splits, rows_per_split,
                               bm, nseg, seg_rows);
  }
  return (int)err;
}
