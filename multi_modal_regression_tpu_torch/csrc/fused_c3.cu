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
// Forward design: an implicit GEMM over M = B*H*W output pixels on the
// building blocks of sm90_tiles.cuh (cp.async ring, ldmatrix, mma.sync
// m16n8k16), two launches:
//   1. c3_fwd_kernel: tiles of BM (256, or 128 where W is so wide that the
//      halo of 256 would keep two blocks off an SM) consecutive pixels x 64
//      output channels; a block walks every mgroups-th tile of one channel
//      tile (at most 264 blocks, 2 an SM), in steps of 16 input channels
//      through 2 ring slots that run on across its tiles (3 would keep two
//      blocks of 256 pixels off an SM). Per step one
//      halo of x (rows m0 - W - 1 .. m0 + BM + W, or, where 2 W + 2 exceeds
//      2 (BM + 2), three runs of BM + 2 around m0 - W, m0, m0 + W) and the 9
//      taps' 64 x 16 weight tiles land in the slot; the prologue is applied
//      once per halo element there, by the thread that copied it. All 9
//      taps read their A rows from that one halo through per-lane ldmatrix
//      addresses (pixel p + dy W + dx); a lane whose neighbour lies outside
//      the image (border, image seam inside the tile, ragged end) points at
//      a row of zeros that the prologue never touches, which is the padding
//      after the prologue. A 144-deep reduction a step; the epilogue is
//      fused_mm.cu's (y rounded in registers and written in 16-byte chunks,
//      running fixed-order statistics, one partial per block). 256-pixel
//      tiles halve the weight bytes per pixel that every step pulls from L2
//      against 128.
//   2. reduce_partials_kernel sums the partials in a fixed order.
//   Where the tiles are fewer than the SMs (layer4: 10 x 8 tiles), C is
//   split to fill the card (3 splits there): launch 1 writes each split's
//   float32 products and launch 2 is split_fixup_kernel (fused_tiles.cuh),
//   which sums them in split order, rounds once, writes y and takes the
//   sums of the rounded y in a fixed order.
// Per block (ptxas -v, sm_90a; registers with / without the prologue):
// 256 threads; BM 256: 128 / 128 registers, 24 / 24 bytes of spills; BM
// 128: 126 / 123, no spills; shared memory 48 + 32 BM + slots x (48 x halo
// + 27,648) bytes for a halo of `halo` rows: 94,960 B at 56 x 56, 89,584 at
// 28 x 28, 86,896 at 14 x 14, 85,552 at 7 x 7 (BM 256, 2 slots); two blocks
// an SM. Bytes from device memory, at least: x and y once (the bound's
// 2 M C + 2 M Cout); the halo's overlap, the other channel tiles' re-reads
// of x and the weight tiles come from L2. Not yet: wgmma, TMA, x
// transformed once for all output-channel tiles.
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
using namespace mmr::sm90;

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

constexpr int kLd64 = 72;  // pitch of a 64-channel tile
constexpr int kChunk = 16;  // channels of one ring step of the forward and dx kernels
constexpr int kLdH = kChunk + 8;  // pitch of a 16-channel tile (halo, forward weights)

// ---- forward ----------------------------------------------------------------

// Halo row j (of nseg segments of seg_rows rows) holds pixel m0 - W - 1 + j
// with one segment; with three, row s seg_rows + t holds m0 + (s - 1) W -
// 1 + t.
__device__ __forceinline__ int halo_pixel(int j, int m0, int W, int nseg, int seg_rows) {
  return nseg == 1 ? m0 - (W + 1) + j : m0 + (j / seg_rows - 1) * W - 1 + j % seg_rows;
}

constexpr int kFwdStages = 2;  // ring slots of the forward

// Shared memory of the forward: a row of zeros, the running statistics
// (WM x 2 x 64 floats), then the slots the ring uses (kFwdStages, or fewer
// where the block has fewer steps; per slot the halo of x, halo rows x 16
// channels, and the 9 taps' 64 x 16 weight tiles).
inline int c3_fwd_smem(int bm, int halo_rows, int steps) {
  const int slots = kFwdStages < steps ? kFwdStages : steps;
  return kLdH * 2 + (bm / 32) * 2 * 64 * 4 + slots * (halo_rows * kLdH + 9 * 64 * kLdH) * 2;
}

// Block (g, ot) owns output channels o0 = 64 ot.. and the pixel tiles g,
// g + mgroups, ..: BM pixels (m0..) each; 8 warps as WM = BM / 32 (pixels)
// x WN = 8 / WM (channels), each 32 x (64 / WN). The ring runs over the
// block's (tile, 16-channel step) pairs in order, kFwdStages slots, so the
// next tile's loads are in flight while this one multiplies and writes y.
// Per step one halo of x, the prologue applied once per halo element in the
// slot (rows outside [0, M) and channels past C stay the zeros cp.async
// wrote), and the 9 taps' weight tiles; all 9 taps read their A rows from
// that halo, a 144-deep reduction a step. With one split, each tile's y
// and statistics come out in the epilogue and the block's statistics over
// all its tiles are one partial, p = g; with ksplit > 1, block (g, ot, sp)
// walks split sp of the channel steps (ceil(csteps / ksplit) each, the last
// shorter) and each tile's float32 products go to ypart[sp] (mgroups is
// then every tile) for split_fixup_kernel.
template <bool PRO, int BM>
__global__ void __launch_bounds__(256, 2)
c3_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w9,
              const float* __restrict__ ab, bf16* __restrict__ y,
              float* __restrict__ partial, int H, int W, int C, int Cout, int M, int relu,
              int seg_rows, int nseg, int mgroups, int ksplit) {
  constexpr int WM = BM / 32, WN = 8 / WM, NI = 64 / WN / 8;
  constexpr int kB = 9 * 64 * kLdH, kWChunks = 9 * 64 * 2;  // weight chunks a step
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* zrow = reinterpret_cast<bf16*>(smem);
  float* sRed = reinterpret_cast<float*>(smem + kLdH * 2);
  bf16* ring = reinterpret_cast<bf16*>(smem + kLdH * 2 + WM * 2 * 64 * 4);
  const int halo = nseg * seg_rows, kA = halo * kLdH, kStage = kA + kB;
  if (threadIdx.x < kLdH / 8) store_chunk(zrow + 8 * threadIdx.x, zero_chunk());
  for (int i = threadIdx.x; i < WM * 2 * 64; i += 256) sRed[i] = 0.0f;
  const int otiles = cdiv(Cout, 64), mtiles = cdiv(M, BM), csteps = cdiv(C, kChunk);
  int b = blockIdx.x;
  const int ot = b % otiles;
  b /= otiles;
  const int g = b % mgroups, sp = b / mgroups;
  const int o0 = ot * 64;
  const int cper = cdiv(csteps, ksplit), cbegin = sp * cper;
  const int ccount = min(cper, csteps - cbegin);  // steps of this split
  const int nsteps = cdiv(mtiles - g, mgroups) * ccount;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, wm = warp / WN, wn = warp % WN;
  const int cc = (threadIdx.x % 2) * 8;  // every chunk of this thread: channels c0 + cc..
  // step q: tile u = q / ccount (pixels m0..), channels c0..
  auto tile_of = [&](int q, int& m0, int& c0) {
    const int u = q / ccount;
    m0 = (g + u * mgroups) * BM;
    c0 = (cbegin + q - u * ccount) * kChunk;
  };

  auto load = [&](int s, int q) {
    int m0, c0;
    tile_of(q, m0, c0);
    bf16* sA = ring + s * kStage;
    bf16* sB = sA + kA;
    const bool cv = c0 + cc < C;
    for (int c = threadIdx.x; c < halo * 2; c += 256) {
      const int q2 = halo_pixel(c / 2, m0, W, nseg, seg_rows);
      const bool v = q2 >= 0 && q2 < M && cv;
      cp_async16(sA + (c / 2) * kLdH + cc, x + (v ? (long long)q2 * C + c0 + cc : 0), v);
    }
#pragma unroll
    for (int u = 0; u < (kWChunks + 255) / 256; ++u) {
      const int c = threadIdx.x + 256 * u, tap = c / 128, row = (c % 128) / 2;
      if (c < kWChunks) {
        const bool v = o0 + row < Cout && cv;
        cp_async16(sB + (tap * 64 + row) * kLdH + cc,
                   w9 + (v ? ((long long)tap * Cout + o0 + row) * C + c0 + cc : 0), v);
      }
    }
  };
  // xhat in place on the halo's chunks that hold pixels of x
  auto transform = [&](int s, int q) {
    int m0, c0;
    tile_of(q, m0, c0);
    if (c0 + cc >= C) return;
    bf16* sA = ring + s * kStage;
    const Ab8 abc = load_ab8(ab, C, c0 + cc);
    for (int c = threadIdx.x; c < halo * 2; c += 256) {
      const int q2 = halo_pixel(c / 2, m0, W, nseg, seg_rows);
      if (q2 >= 0 && q2 < M) {
        bf16* p = sA + (c / 2) * kLdH + cc;
        store_chunk(p, prologue8(load_chunk(p), abc, relu));
      }
    }
  };

  // this lane's A rows (one per m16 tile) and, per tile, the taps whose
  // neighbour p + dy W + dx lies inside the image (a masked tap reads the
  // zero row: the padding comes after the prologue)
  const int arow = wm * 32 + a_row(lane);  // + 16 i
  unsigned amask[2] = {0u, 0u};
  float acc[2][NI][4];
  zero_acc(acc);

  for (int s = 0; s < kFwdStages - 1; ++s) {
    if (s < nsteps) load(s, s);
    cp_async_commit();
  }
  for (int q = 0; q < nsteps; ++q) {
    cp_async_wait<kFwdStages - 2>();
    const int s = q % kFwdStages;
    if (PRO) transform(s, q);
    __syncthreads();
    if (q + kFwdStages - 1 < nsteps) {
      load((q + kFwdStages - 1) % kFwdStages, q + kFwdStages - 1);
    }
    cp_async_commit();
    int m0, c0;
    tile_of(q, m0, c0);
    if (q % ccount == 0) {  // a new tile
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = m0 + arow + 16 * i, hp = (p / W) % H, wp = p % W;
        amask[i] = 0u;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int dy = tap / 3 - 1, dx = tap % 3 - 1;
          if (p < M && hp + dy >= 0 && hp + dy < H && wp + dx >= 0 && wp + dx < W) {
            amask[i] |= 1u << tap;
          }
        }
      }
    }
    const bf16* sA = ring + s * kStage;
    const bf16* sB = sA + kA;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      // halo row of the neighbour p + dy W + dx: seg + (p - m0) + dx
      const int seg = nseg == 1 ? (W + 1) + dy * W : (dy + 1) * seg_rows + 1;
      unsigned a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bf16* row =
            (amask[i] >> tap) & 1u ? sA + (seg + arow + 16 * i + dx) * kLdH : zrow;
        ldsm_x4(a[i], row + a_col(lane));
      }
#pragma unroll
      for (int jj = 0; jj < NI / 2; ++jj) {  // B = w9[tap]^T, held as [cout][c]
        unsigned r[4];
        ldsm_x4(r, sB + (tap * 64 + wn * 8 * NI + jj * 16 + b_row(lane)) * kLdH + b_col(lane));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma16816(acc[i][2 * jj], a[i], r[0], r[1]);
          mma16816(acc[i][2 * jj + 1], a[i], r[2], r[3]);
        }
      }
    }
    if ((q + 1) % ccount == 0) {  // the tile's last step of this split
      if (ksplit == 1) {
        y_stats_tile<NI, 64>(acc, y, sRed, wm, wm * 32, wn * 8 * NI, m0, o0, M, Cout);
      } else {
        store_acc_f32<NI>(acc, partial + (long long)sp * M * Cout, m0 + wm * 32,
                          o0 + wn * 8 * NI, M, Cout);
      }
      zero_acc(acc);
    }
  }
  cp_async_wait<0>();
  if (ksplit > 1) return;
  __syncthreads();
  write_stats_partial<WM, 64>(sRed, partial, g, o0, Cout);
}

template <bool PRO>
cudaError_t launch_c3_fwd(cudaStream_t st, const bf16* x, const bf16* w9, const float* ab,
                          bf16* y, float* partial, int H, int W, int C, int Cout, int M,
                          int relu, int bm, int nseg, int seg_rows, int mgroups, int ksplit) {
  const int csteps = cdiv(C, kChunk);
  if ((bm != 128 && bm != 256) || mgroups < 1 || mgroups > cdiv(M, bm) || ksplit < 1 ||
      (ksplit > 1 && (mgroups != cdiv(M, bm) || (ksplit - 1) * cdiv(csteps, ksplit) >= csteps)) ||
      !((nseg == 1 && seg_rows == bm + 2 * W + 2) || (nseg == 3 && seg_rows == bm + 2))) {
    return cudaErrorInvalidValue;
  }
  const int steps = cdiv(cdiv(M, bm), mgroups) * cdiv(csteps, ksplit);
  const int smem = c3_fwd_smem(bm, nseg * seg_rows, steps);
  const unsigned int grid = (unsigned int)ksplit * mgroups * cdiv(Cout, 64);
  cudaError_t err;
  if (bm == 256) {
    err = allow_smem(c3_fwd_kernel<PRO, 256>, smem);
    if (err != cudaSuccess) return err;
    c3_fwd_kernel<PRO, 256><<<grid, 256, smem, st>>>(x, w9, ab, y, partial, H, W, C, Cout, M,
                                                     relu, seg_rows, nseg, mgroups, ksplit);
  } else {
    err = allow_smem(c3_fwd_kernel<PRO, 128>, smem);
    if (err != cudaSuccess) return err;
    c3_fwd_kernel<PRO, 128><<<grid, 256, smem, st>>>(x, w9, ab, y, partial, H, W, C, Cout, M,
                                                     relu, seg_rows, nseg, mgroups, ksplit);
  }
  return cudaGetLastError();
}

// ---- backward ---------------------------------------------------------------

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
// (B, H, W, Cout) bf16; partial (mgroups, 2, Cout) float32 scratch; sums
// (2, Cout) float32. bm in {128, 256} pixels a tile; the halo is nseg == 1
// segment of bm + 2 W + 2 rows or
// nseg == 3 of bm + 2 (seg_rows); mgroups (1 .. ceil(B*H*W / bm)) blocks
// per 64 output channels, each taking every mgroups-th tile; ksplit the
// splits of C (1, or with mgroups = ceil(B*H*W / bm) up to one per 16
// channels, none empty). Scratch `partial`: (mgroups, 2, Cout) float32 with
// one split, else (ksplit, B*H*W, Cout) float32. Two launches. Returns the
// first CUDA error.
extern "C" int mmr_c3_fwd(const void* x, const void* w9, const void* ab, void* y,
                          void* partial, void* sums, int B, int H, int W, int C, int Cout,
                          int relu, int bm, int nseg, int seg_rows, int mgroups, int ksplit,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int M = B * H * W;
  if (ab != nullptr) {
    err = launch_c3_fwd<true>(st, (const bf16*)x, (const bf16*)w9, (const float*)ab, (bf16*)y,
                              (float*)partial, H, W, C, Cout, M, relu, bm, nseg,
                              seg_rows, mgroups, ksplit);
  } else {
    err = launch_c3_fwd<false>(st, (const bf16*)x, (const bf16*)w9, nullptr, (bf16*)y,
                               (float*)partial, H, W, C, Cout, M, 0, bm, nseg,
                               seg_rows, mgroups, ksplit);
  }
  if (err != cudaSuccess) return (int)err;
  if (ksplit == 1) {
    return (int)reduce_partials((const float*)partial, (float*)sums, mgroups, 2LL * Cout, st);
  }
  return (int)split_fixup((const float*)partial, (bf16*)y, (float*)sums, M, Cout, ksplit, st);
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
