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
// Forward, bound on the H100: memory for the shapes of layer1-3 (x read, y
// written once: 2 M K + 2 M N bytes against 2 M N K operations, e.g. M
// 150528, K 64, N 256: 96 MB, 0.0288 ms) and operations at layer4 (M 2352).
// Two launches (sm90_tiles.cuh: a cp.async ring of 64-deep steps, ldmatrix +
// mma.sync m16n8k16):
//   1. mm_stats_kernel: y tiles of BM x BN (128 x 64 for N <= 64, 64 x 256
//      where K is one step and N >= 256, else 128 x 128; chosen by the
//      wrapper). A block walks every mgroups-th M tile of one N tile, so a
//      grid of at most 264 blocks (2 an SM) covers any M, and its ring runs
//      over all its (tile, step) pairs: the next tile's loads fly while this
//      one multiplies and writes y. Where K is one step, w is loaded once
//      and the slots hold x alone. xhat is formed in the ring slot by the
//      thread that copied each chunk of x, once per element per N tile:
//      once at layer1's N 256. y is rounded to bf16 in registers and
//      written straight from them in 16-byte chunks (a quad of lanes swaps
//      its pairs so that two lanes write one 32-byte sector); each tile's
//      (sum y, sum y^2) of the rounded values goes by xor shuffles within a
//      warp into running per-warp sums in shared memory, and the block
//      writes one partial, its warps summed in order.
//   2. reduce_partials_kernel sums the (at most 264) partials in a fixed
//      order.
//   Where the tiles are fewer than the SMs (layer4's 2048 -> 512: 76 tiles
//   of 128 x 128), K is split to fill the card (3 splits there): launch 1
//   writes each split's float32 products (ksplit M N floats of scratch,
//   14.5 MB at layer4, mostly in L2), and launch 2 is split_fixup_kernel
//   (fused_tiles.cuh), which sums them in split order, rounds once, writes
//   y in 16-byte chunks and takes the sums of the rounded y in a fixed
//   order.
// Per block (ptxas -v, sm_90a; registers with / without the prologue):
//   BM x BN     threads  shared memory: a ring slot; + statistics   registers
//   128 x 64    256      27,648 B (one-step K: 18,432 + w 9,216); 2,048 B   107 / 97
//   128 x 128   256      36,864 B; 4,096 B                          128 / 128
//   64 x 256    256      46,080 B (one-step K: 9,216 + w 36,864); 4,096 B  128 / 128
//   split_fixup_kernel 1024 threads, 56 registers, 2,048 B static
// with 3 slots (fewer where the block has fewer steps; two blocks an SM at
// every tile); no spills. Bytes from device memory, at least: x once
// (the N tiles of one M tile run at the same time and share it through
// L2), w from L2, y once: the bound's 2 M K + 2 M N, plus 8 N per block of
// partials. Not yet: wgmma, TMA, a stream-K split that evens out the last
// wave (at 592 tiles on 264 blocks, some blocks walk 3 tiles, most 2).
//
// Backward, bound on the H100: memory for the shapes of layer1-3 (gy, y, x
// read and dx written once: 4 M N + 4 M K bytes against 4 M N K operations,
// e.g. M 150528, K 64, N 256: 193 MB, 0.0575 ms) and operations at layer4
// (M 2352). Two launches (sm90_tiles.cuh: a 3-stage cp.async ring, 64-deep
// steps, ldmatrix + mma.sync m16n8k16):
//   1. mm_bwd_dw_kernel: one TN x TK tile of dw per block (128 on a side
//      of more than 64 channels, else 64) over a split of the rows. gy_eff
//      and xhat are formed once per element of the tile, in the ring slot,
//      and feed the product from there: gy_eff K / TK times over the grid,
//      xhat N / TN times (the re-reads of gy, y and x by the other tiles of
//      a split, neighbours in the grid, come from L2). The blocks of the
//      first K tile also write gy_eff to scratch (bf16, M x N), so the dx
//      product never reads gy and y. dw per split is a partial, or dw
//      itself when one split covers M; the wrapper splits only while the
//      tiles fill under half the card. Block 0 zeroes launch 2's counters.
//   2. mm_bwd_dx_kernel: one BM x BN tile of dx (BM 128 or 64, BN 128 or
//      64, chosen by the wrapper to fill the card) over gy_eff and w, with
//      the mask, dx = bf16(dz * a) and the block's da, db partial in the
//      epilogue; the blocks that finish a group of 16 M tiles last sum its
//      da, db partials, and the last group the groups, in a fixed order
//      (integer arrival counters, no float atomics). Then every block sums
//      its share of launch 1's dw partials, in a fixed order.
// Per block (ptxas -v, sm_90a; registers with / without the prologue):
//   dw TN x TK   threads  shared memory  registers
//   64 x 64      128       82,944 B      116 / 96
//   128 x 64     256      132,096 B      101 / 98
//   64 x 128     256      107,520 B       98 / 80
//   128 x 128    256      156,672 B      128 / 126
//   dx BM x BN   threads  shared memory  registers
//   64 x 64      256       55,296 B       64 / 64
//   64 x 128     256       79,872 B       80 / 96
//   128 x 64     256       82,944 B       72 / 72
//   128 x 128    256      107,520 B      130 / 126
// (+ 128 B of static shared memory with the prologue); no spills. Above
// 48 KB the kernels need cudaFuncSetAttribute: set once per kernel and
// device (sm90::allow_smem), its error and every launch's checked.
// Bytes from device memory, at least: launch 1 reads gy, y, x (4 M N + 2 M K)
// and writes gy_eff (2 M N); launch 2 reads gy_eff and x (2 M N + 2 M K) and
// writes dx (2 M K): 8 M N + 6 M K in all (M 150528, K 64, N 256: 366 MB,
// 0.109 ms), against 4 M N + 4 M K for the bound. Not yet: one pass that
// keeps dw in registers for the small N K of layer1 (reads gy, y, x once),
// wgmma, TMA. (Clusters of K tiles sharing one gy_eff tile through
// distributed shared memory, a cluster barrier a step, measured slower.)

#include "sm90_tiles.cuh"

namespace {

using namespace mmr;
using namespace mmr::sm90;

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

constexpr int kLd64 = 72;  // pitch of a 64-column tile
constexpr int kSteps = 64;  // depth of one ring step

// ---- forward ----------------------------------------------------------------

// The forward's BM x BN tile: WM = BM / 32 warps along M, WN = 8 / WM along
// N, each warp 32 rows x (BN / WN) columns. A ring slot holds 64 channels
// of BM rows of x (-> xhat) and, unless K is one step, of BN rows of w;
// after the ring, w when K is one step (the same for every tile of the
// block, so loaded once) and the warps' running statistics (WM x 2 x BN
// floats).
template <int BM, int BN>
struct FwdTile {
  static constexpr int kWM = BM / 32, kWN = 8 / kWM;
  static constexpr int kNI = BN / kWN / 8;
  static constexpr int kA = BM * kLd64, kB = BN * kLd64;
  static constexpr int kRed = kWM * 2 * BN * 4;
};

// Dynamic shared memory of one forward block that runs `steps` ring steps
// of a K of ksteps 64-deep steps: the slots the ring uses (kStages, or
// fewer where the block has fewer steps), w once when K is one step, and
// the running statistics. At every tile kStages slots keep two blocks an
// SM (84,992 B at most, 128 x 128).
template <int BM, int BN>
int fwd_smem(int steps, int ksteps) {
  using T = FwdTile<BM, BN>;
  const int slots = kStages < steps ? kStages : steps;
  const int ring = ksteps == 1 ? slots * T::kA + T::kB : slots * (T::kA + T::kB);
  return ring * 2 + T::kRed;
}

// Block (g, nt, sp) owns columns n0 = nt BN.. of y, the M tiles g, g +
// mgroups, g + 2 mgroups, .., and split sp of the K steps (ksplit splits,
// each ceil(ksteps / ksplit) steps, the last shorter). The ring runs over
// the block's (tile, 64-deep step) pairs in order through kStages slots,
// so the next tile's loads are in flight while this one multiplies and
// writes y. xhat is formed in the slot by the thread that copied each
// chunk, once per element per N tile. With one split, each tile's y and
// statistics come out in the epilogue and the block's statistics over all
// its tiles are one partial, p = g; with ksplit > 1, each tile's float32
// products over the split go to ypart[sp] (mgroups is then every M tile)
// for split_fixup_kernel.
template <bool PRO, int BM, int BN>
__global__ void __launch_bounds__(256, 2)
mm_stats_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const float* __restrict__ ab, bf16* __restrict__ y,
                float* __restrict__ partial, int M, int K, int N, int relu, int mgroups,
                int ksplit) {
  using T = FwdTile<BM, BN>;
  constexpr int NI = T::kNI;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int ntiles = cdiv(N, BN), mtiles = cdiv(M, BM), ksteps = cdiv(K, kSteps);
  int b = blockIdx.x;
  const int nt = b % ntiles;
  b /= ntiles;
  const int g = b % mgroups, sp = b / mgroups;
  const int n0 = nt * BN;
  const int kper = cdiv(ksteps, ksplit), kbegin = sp * kper;
  const int kcount = min(kper, ksteps - kbegin);  // steps of this split
  const int nsteps = cdiv(mtiles - g, mgroups) * kcount;
  const int slots = kStages < nsteps ? kStages : nsteps;
  const bool wonce = ksteps == 1;  // w the same for every step: loaded once
  const int stage = wonce ? T::kA : T::kA + T::kB;
  bf16* wres = ring + slots * stage;
  float* sRed = reinterpret_cast<float*>(wres + (wonce ? T::kB : 0));
  for (int i = threadIdx.x; i < T::kWM * 2 * BN; i += 256) sRed[i] = 0.0f;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / T::kWN, wn = warp % T::kWN;
  const int ck = (threadIdx.x % 8) * 8;  // every chunk of this thread: channels k0 + ck..
  // step q: tile u = q / kcount (rows m0..), channels k0..
  auto tile_of = [&](int q, int& m0, int& k0) {
    const int u = q / kcount;
    m0 = (g + u * mgroups) * BM;
    k0 = (kbegin + q - u * kcount) * kSteps;
  };
  auto load_w = [&](bf16* sB, int k0) {
    const bool kv = k0 + ck < K;
#pragma unroll
    for (int u = 0; u < BN * 8 / 256; ++u) {
      const int row = (threadIdx.x + 256 * u) / 8, gn = n0 + row;
      const bool v = gn < N && kv;
      cp_async16(sB + row * kLd64 + ck, w + (v ? (long long)gn * K + k0 + ck : 0), v);
    }
  };
  auto load = [&](int s, int q) {
    int m0, k0;
    tile_of(q, m0, k0);
    bf16* sA = ring + s * stage;
    const bool kv = k0 + ck < K;
#pragma unroll
    for (int u = 0; u < BM * 8 / 256; ++u) {
      const int row = (threadIdx.x + 256 * u) / 8, gm = m0 + row;
      const bool v = gm < M && kv;
      cp_async16(sA + row * kLd64 + ck, x + (v ? (long long)gm * K + k0 + ck : 0), v);
    }
    if (!wonce) load_w(sA + T::kA, k0);
  };
  // xhat in place; chunks outside x stay the zeros cp.async wrote
  auto transform = [&](int s, int q) {
    int m0, k0;
    tile_of(q, m0, k0);
    if (k0 + ck >= K) return;
    bf16* sA = ring + s * stage;
    const Ab8 abc = load_ab8(ab, K, k0 + ck);
#pragma unroll
    for (int u = 0; u < BM * 8 / 256; ++u) {
      const int row = (threadIdx.x + 256 * u) / 8;
      if (m0 + row < M) {
        store_chunk(sA + row * kLd64 + ck, prologue8(load_chunk(sA + row * kLd64 + ck), abc, relu));
      }
    }
  };

  float acc[2][NI][4];
  zero_acc(acc);

  if (wonce) load_w(wres, 0);  // in the first group, with step 0
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) load(s, s);
    cp_async_commit();
  }
  for (int q = 0; q < nsteps; ++q) {
    cp_async_wait<kStages - 2>();
    const int s = q % kStages;
    if (PRO) transform(s, q);
    __syncthreads();
    if (q + kStages - 1 < nsteps) load((q + kStages - 1) % kStages, q + kStages - 1);
    cp_async_commit();
    const bf16* sA = ring + s * stage;
    const bf16* sB = wonce ? wres : sA + T::kA;
#pragma unroll
    for (int kk = 0; kk < kSteps; kk += 16) {
      unsigned a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ldsm_x4(a[i], sA + (wm * 32 + i * 16 + a_row(lane)) * kLd64 + kk + a_col(lane));
      }
#pragma unroll
      for (int jj = 0; jj < NI / 2; ++jj) {  // B = w^T, held as w[n][k]
        unsigned r[4];
        ldsm_x4(r, sB + (wn * 8 * NI + jj * 16 + b_row(lane)) * kLd64 + kk + b_col(lane));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma16816(acc[i][2 * jj], a[i], r[0], r[1]);
          mma16816(acc[i][2 * jj + 1], a[i], r[2], r[3]);
        }
      }
    }
    if ((q + 1) % kcount == 0) {  // the tile's last step of this split
      int m0, k0;
      tile_of(q, m0, k0);
      if (ksplit == 1) {
        y_stats_tile<NI, BN>(acc, y, sRed, wm, wm * 32, wn * 8 * NI, m0, n0, M, N);
      } else {
        store_acc_f32<NI>(acc, partial + (long long)sp * M * N, wm * 32 + m0,
                          wn * 8 * NI + n0, M, N);
      }
      zero_acc(acc);
    }
  }
  cp_async_wait<0>();
  if (ksplit > 1) return;
  __syncthreads();
  write_stats_partial<T::kWM, BN>(sRed, partial, g, n0, N);
}

template <bool PRO, int BM, int BN>
cudaError_t launch_mm_fwd(cudaStream_t st, const bf16* x, const bf16* w, const float* ab,
                          bf16* y, float* partial, int M, int K, int N, int relu, int mgroups,
                          int ksplit) {
  const int ksteps = cdiv(K, kSteps);
  const int steps = cdiv(cdiv(M, BM), mgroups) * cdiv(ksteps, ksplit);
  const int smem = fwd_smem<BM, BN>(steps, ksteps);
  cudaError_t err = allow_smem(mm_stats_kernel<PRO, BM, BN>, smem);
  if (err != cudaSuccess) return err;
  const unsigned int grid = (unsigned int)ksplit * mgroups * cdiv(N, BN);
  mm_stats_kernel<PRO, BM, BN><<<grid, 256, smem, st>>>(x, w, ab, y, partial, M, K, N, relu,
                                                        mgroups, ksplit);
  return cudaGetLastError();
}

template <bool PRO>
cudaError_t launch_mm_stats(cudaStream_t st, const bf16* x, const bf16* w, const float* ab,
                            bf16* y, float* partial, int M, int K, int N, int relu, int bm,
                            int bn, int mgroups, int ksplit) {
#define MMR_MM_FWD(BM, BN) \
  launch_mm_fwd<PRO, BM, BN>(st, x, w, ab, y, partial, M, K, N, relu, mgroups, ksplit)
  const int ksteps = cdiv(K, kSteps);
  if (mgroups < 1 || mgroups > cdiv(M, bm) || ksplit < 1 ||
      (ksplit > 1 && (mgroups != cdiv(M, bm) || (ksplit - 1) * cdiv(ksteps, ksplit) >= ksteps))) {
    return cudaErrorInvalidValue;
  }
  if (bm == 128 && bn == 64) return MMR_MM_FWD(128, 64);
  if (bm == 128 && bn == 128) return MMR_MM_FWD(128, 128);
  if (bm == 64 && bn == 256) return MMR_MM_FWD(64, 256);
#undef MMR_MM_FWD
  return cudaErrorInvalidValue;
}

// ---- backward ---------------------------------------------------------------

// The dw kernel's tile: TN output channels x TK input channels (64 or 128
// each), by WK = TK / 32 warps along K and WN = min(TN / 32, 8 / WK) along
// N; each warp owns (TN / WN) x 32.
template <int TN, int TK>
struct DwTile {
  static constexpr int kWK = TK / 32;
  static constexpr int kWN = TN / 32 < 8 / kWK ? TN / 32 : 8 / kWK;
  static constexpr int kThreads = 32 * kWN * kWK;
  static constexpr int kMI = TN / kWN / 16, kNI = 4;
  static constexpr int kLdN = TN + 8, kLdK = TK + 8;
  // per stage: gy (-> gy_eff) and y of 64 rows x TN, x (-> xhat) of 64 x TK
  static constexpr int kStage = 2 * kSteps * kLdN + kSteps * kLdK;
  static constexpr int kGyChunks = kSteps * (TN / 8) / kThreads;  // per thread
  static constexpr int kSmem = kStages * kStage * 2;
};

// A TN x TK tile of dw (n0.., k0..) over the rows of one split; out is
// (splits, N, K), or dw when there is one split.
template <bool PRO, int TN, int TK>
__global__ void __launch_bounds__(DwTile<TN, TK>::kThreads)
mm_bwd_dw_kernel(const bf16* __restrict__ gy, const bf16* __restrict__ y,
                 const bf16* __restrict__ x, const float* __restrict__ gs,
                 const float* __restrict__ ab, bf16* __restrict__ ge, float* __restrict__ out,
                 unsigned* __restrict__ cnt, int ncnt, int M, int K, int N, int relu,
                 int rows_per_split) {
  using T = DwTile<TN, TK>;
  constexpr int kT = T::kThreads, kLdN = T::kLdN, kLdK = T::kLdK, MI = T::kMI, NI = T::kNI;
  constexpr int kCn = TN / 8, kCk = TK / 8;  // chunks per row
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < ncnt; i += kT) cnt[i] = 0u;
  }
  const int ktiles = cdiv(K, TK), ntiles = cdiv(N, TN);
  int b = blockIdx.x;
  const int kt = b % ktiles;
  b /= ktiles;
  const int nt = b % ntiles, split = b / ntiles;
  const int n0 = nt * TN, k0 = kt * TK;
  const int m_begin = split * rows_per_split;
  const int m_end = min(m_begin + rows_per_split, M);
  const int nsteps = cdiv(m_end - m_begin, kSteps);
  const bool write_ge = kt == 0;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wa = warp / T::kWK, wb = warp % T::kWK;
  // chunk c = threadIdx.x + kT u of a tile is row c / (cols / 8), channels
  // 8 (c % (cols / 8)).., the same channels at every u and every step
  const int cn = (threadIdx.x % kCn) * 8, ck = (threadIdx.x % kCk) * 8;
  const Gs8 gsc = load_gs8(gs, N, n0 + cn);
  const Ab8 abc = load_ab8(PRO ? ab : nullptr, K, k0 + ck);

  auto load = [&](int s, int mb) {
    bf16* sG = ring + s * T::kStage;
    bf16* sY = sG + kSteps * kLdN;
    bf16* sX = sY + kSteps * kLdN;
#pragma unroll
    for (int u = 0; u < T::kGyChunks; ++u) {
      const int row = (threadIdx.x + kT * u) / kCn, gm = mb + row;
      const bool v = gm < m_end && n0 + cn < N;
      const long long at = v ? (long long)gm * N + n0 + cn : 0;
      cp_async16(sG + row * kLdN + cn, gy + at, v);
      cp_async16(sY + row * kLdN + cn, y + at, v);
    }
#pragma unroll
    for (int u = 0; u < kSteps * kCk / kT; ++u) {
      const int row = (threadIdx.x + kT * u) / kCk, gm = mb + row;
      const bool v = gm < m_end && k0 + ck < K;
      cp_async16(sX + row * kLdK + ck, x + (v ? (long long)gm * K + k0 + ck : 0), v);
    }
  };
  // gy_eff into the gy slot and xhat in place, zero outside the matrices
  auto transform = [&](int s, int mb) {
    bf16* sG = ring + s * T::kStage;
    const bf16* sY = sG + kSteps * kLdN;
    bf16* sX = sG + 2 * kSteps * kLdN;
#pragma unroll
    for (int u = 0; u < T::kGyChunks; ++u) {
      const int row = (threadIdx.x + kT * u) / kCn, gm = mb + row;
      Chunk g = zero_chunk();
      if (gm < m_end && n0 + cn < N) {
        g = gy_eff8(load_chunk(sG + row * kLdN + cn), load_chunk(sY + row * kLdN + cn), gsc);
        if (write_ge) store_chunk(ge + (long long)gm * N + n0 + cn, g);
      }
      store_chunk(sG + row * kLdN + cn, g);
    }
#pragma unroll
    for (int u = 0; u < kSteps * kCk / kT; ++u) {
      const int row = (threadIdx.x + kT * u) / kCk, gm = mb + row;
      Chunk xv = zero_chunk();
      if (gm < m_end && k0 + ck < K) {
        xv = load_chunk(sX + row * kLdK + ck);
        if (PRO) xv = prologue8(xv, abc, relu);
      }
      store_chunk(sX + row * kLdK + ck, xv);
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) load(s, m_begin + s * kSteps);
    cp_async_commit();
  }
  for (int it = 0; it < nsteps; ++it) {
    cp_async_wait<kStages - 2>();
    const int s = it % kStages;
    transform(s, m_begin + it * kSteps);
    __syncthreads();
    const int nx = it + kStages - 1;
    if (nx < nsteps) load(nx % kStages, m_begin + nx * kSteps);
    cp_async_commit();
    const bf16* sG = ring + s * T::kStage;
    const bf16* sX = sG + 2 * kSteps * kLdN;
#pragma unroll
    for (int kk = 0; kk < kSteps; kk += 16) {
      unsigned a[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {  // A = gy_eff^T: rows n, reduction over m
        ldsm_x4_t(a[i], sG + (kk + at_row(lane)) * kLdN + wa * 16 * MI + i * 16 + at_col(lane));
      }
#pragma unroll
      for (int jj = 0; jj < NI / 2; ++jj) {  // B = xhat: reduction over m, columns k
        unsigned r[4];
        ldsm_x4_t(r, sX + (kk + bt_row(lane)) * kLdK + wb * 32 + jj * 16 + bt_col(lane));
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          mma16816(acc[i][2 * jj], a[i], r[0], r[1]);
          mma16816(acc[i][2 * jj + 1], a[i], r[2], r[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  float* o = out + (long long)split * N * K;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int n = n0 + wa * 16 * MI + i * 16 + g, k = k0 + wb * 32 + j * 8 + 2 * t;
      if (k >= K) continue;
      if (n < N) {
        *reinterpret_cast<float2*>(o + (long long)n * K + k) =
            make_float2(acc[i][j][0], acc[i][j][1]);
      }
      if (n + 8 < N) {
        *reinterpret_cast<float2*>(o + (long long)(n + 8) * K + k) =
            make_float2(acc[i][j][2], acc[i][j][3]);
      }
    }
  }
}

template <bool PRO, int TN, int TK>
cudaError_t launch_mm_dw(int splits, cudaStream_t st, const bf16* gy, const bf16* y,
                         const bf16* x, const float* gs, const float* ab, bf16* ge, float* out,
                         unsigned* cnt, int ncnt, int M, int K, int N, int relu,
                         int rows_per_split) {
  using T = DwTile<TN, TK>;
  cudaError_t err = allow_smem(mm_bwd_dw_kernel<PRO, TN, TK>, T::kSmem);
  if (err != cudaSuccess) return err;
  const unsigned int grid = (unsigned int)splits * ((N + TN - 1) / TN) * ((K + TK - 1) / TK);
  mm_bwd_dw_kernel<PRO, TN, TK><<<grid, T::kThreads, T::kSmem, st>>>(
      gy, y, x, gs, ab, ge, out, cnt, ncnt, M, K, N, relu, rows_per_split);
  return cudaGetLastError();
}

// Shared memory of the dx kernel: the ring (per stage BM x 64 of gy_eff and
// 64 x BN of w), reused for the staged tile, the row-group sums of the
// epilogue and the dw partials' sums (8 x 128 floats).
template <int MI, int NI>
constexpr int dx_smem() {
  const int ring = kStages * (64 * MI * kLd64 + 64 * (16 * NI + 8)) * 2;
  const int epi = (64 * MI * (16 * NI + 4) + 4096 + 1024) * 4;
  return ring > epi ? ring : epi;
}

// One BM x BN tile of dx (BM = 64 MI rows, BN = 16 NI input channels); 8
// warps as 4 (rows) x 2 (columns), each (16 MI) x (8 NI). With splits > 1
// every block then sums its share of launch 1's dw partials.
template <bool PRO, int MI, int NI>
__global__ void __launch_bounds__(256)
mm_bwd_dx_kernel(const bf16* __restrict__ ge, const bf16* __restrict__ x,
                 const bf16* __restrict__ w, const float* __restrict__ ab,
                 bf16* __restrict__ dx, float* __restrict__ part_ab, float* __restrict__ gsum_ab,
                 float* __restrict__ dab, unsigned* __restrict__ cnt,
                 const float* __restrict__ part_dw, float* __restrict__ dw, int M, int K, int N,
                 int relu, int splits) {
  constexpr int BM = 64 * MI, BN = 16 * NI, kLdB = BN + 8;
  constexpr int kA = BM * kLd64, kStage = kA + kSteps * kLdB;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int ktiles = cdiv(K, BN), mtiles = cdiv(M, BM);
  const int mt = blockIdx.x / ktiles, kt = blockIdx.x % ktiles;
  const int m0 = mt * BM, k0 = kt * BN;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;

  auto load = [&](int s, int nn0) {
    bf16* sA = ring + s * kStage;
    bf16* sB = sA + kA;
    for (int c = threadIdx.x; c < BM * 8; c += 256) {
      const int row = c / 8, cc = (c % 8) * 8, gm = m0 + row;
      const bool v = gm < M && nn0 + cc < N;
      cp_async16(sA + row * kLd64 + cc, ge + (v ? (long long)gm * N + nn0 + cc : 0), v);
    }
    for (int c = threadIdx.x; c < kSteps * (BN / 8); c += 256) {
      const int row = c / (BN / 8), cc = (c % (BN / 8)) * 8;
      const bool v = nn0 + row < N && k0 + cc < K;
      cp_async16(sB + row * kLdB + cc, w + (v ? (long long)(nn0 + row) * K + k0 + cc : 0), v);
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int nsteps = cdiv(N, kSteps);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) load(s, s * kSteps);
    cp_async_commit();
  }
  for (int it = 0; it < nsteps; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nx = it + kStages - 1;
    if (nx < nsteps) load(nx % kStages, nx * kSteps);
    cp_async_commit();
    const bf16* sA = ring + (it % kStages) * kStage;
    const bf16* sB = sA + kA;
#pragma unroll
    for (int kk = 0; kk < kSteps; kk += 16) {
      unsigned a[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        ldsm_x4(a[i], sA + (wm * 16 * MI + i * 16 + a_row(lane)) * kLd64 + kk + a_col(lane));
      }
#pragma unroll
      for (int jj = 0; jj < NI / 2; ++jj) {
        unsigned r[4];
        ldsm_x4_t(r, sB + (kk + bt_row(lane)) * kLdB + wn * 8 * NI + jj * 16 + bt_col(lane));
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          mma16816(acc[i][2 * jj], a[i], r[0], r[1]);
          mma16816(acc[i][2 * jj + 1], a[i], r[2], r[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float* sC = reinterpret_cast<float*>(smem);
  float* sRed = sC + BM * (BN + 4);
  stage_acc<MI, NI>(sC, BN + 4, acc, wm * 16 * MI, wn * 8 * NI);
  __syncthreads();
  dx_epilogue<PRO, BM, BN>(sC, sRed, x, ab, dx, part_ab, mt, m0, k0, M, K, relu);
  if (splits > 1) reduce_dw_share(part_dw, dw, splits, (long long)N * K, sRed + 4096);
  if (PRO) {
    const int ngroups = cdiv(mtiles, kGroup);
    reduce_dab_tail(part_ab, gsum_ab, dab, cnt + kt * (ngroups + 1), mtiles, mt, K, k0,
                    min(BN, K - k0));
  }
}

template <bool PRO, int MI, int NI>
cudaError_t launch_mm_dx(unsigned int grid, cudaStream_t st, const bf16* ge, const bf16* x,
                         const bf16* w, const float* ab, bf16* dx, float* part_ab,
                         float* gsum_ab, float* dab, unsigned* cnt, const float* part_dw,
                         float* dw, int M, int K, int N, int relu, int splits) {
  constexpr int smem = dx_smem<MI, NI>();
  cudaError_t err = allow_smem(mm_bwd_dx_kernel<PRO, MI, NI>, smem);
  if (err != cudaSuccess) return err;
  mm_bwd_dx_kernel<PRO, MI, NI><<<grid, 256, smem, st>>>(ge, x, w, ab, dx, part_ab, gsum_ab,
                                                         dab, cnt, part_dw, dw, M, K, N, relu,
                                                         splits);
  return cudaGetLastError();
}

template <bool PRO>
cudaError_t launch_mm_bwd(cudaStream_t st, const bf16* gy, const bf16* y, const bf16* x,
                          const bf16* w, const float* gs, const float* ab, bf16* dx, float* dw,
                          float* dab, bf16* ge, float* part_dw, float* part_ab, float* gsum_ab,
                          unsigned* cnt, int M, int K, int N, int relu, int splits,
                          int rows_per_split, int bm, int bn, int tn, int tk) {
  if ((bm != 64 && bm != 128) || (bn != 64 && bn != 128) || (tn != 64 && tn != 128) ||
      (tk != 64 && tk != 128) || splits < 1 ||
      (long long)splits * rows_per_split < M || rows_per_split % kSteps != 0) {
    return cudaErrorInvalidValue;
  }
  const int mtiles = (M + bm - 1) / bm, ktiles = (K + bn - 1) / bn;
  const int ncnt = PRO ? ktiles * ((mtiles + kGroup - 1) / kGroup + 1) : 0;
#define MMR_MM_DW(TN, TK)                                                                  \
  launch_mm_dw<PRO, TN, TK>(splits, st, gy, y, x, gs, ab, ge, splits == 1 ? dw : part_dw, cnt, \
                            ncnt, M, K, N, relu, rows_per_split)
  cudaError_t err;
  switch ((tn == 128 ? 2 : 0) + (tk == 128 ? 1 : 0)) {
    case 0: err = MMR_MM_DW(64, 64); break;
    case 1: err = MMR_MM_DW(64, 128); break;
    case 2: err = MMR_MM_DW(128, 64); break;
    default: err = MMR_MM_DW(128, 128); break;
  }
#undef MMR_MM_DW
  if (err != cudaSuccess) return err;
  const unsigned int grid = (unsigned int)mtiles * ktiles;
  const int key = (bm == 128 ? 2 : 0) + (bn == 128 ? 1 : 0);
#define MMR_MM_DX(MI, NI)                                                                   \
  launch_mm_dx<PRO, MI, NI>(grid, st, ge, x, w, ab, dx, part_ab, gsum_ab, dab, cnt, part_dw, \
                            dw, M, K, N, relu, splits)
  switch (key) {
    case 0: return MMR_MM_DX(1, 4);
    case 1: return MMR_MM_DX(1, 8);
    case 2: return MMR_MM_DX(2, 4);
    default: return MMR_MM_DX(2, 8);
  }
#undef MMR_MM_DX
}

}  // namespace

// x (M, K), w (N, K) bf16; ab (2, K) float32 or null (no prologue); y (M, N)
// bf16; sums (2, N) float32. The tile bm x bn is 128 x 64, 128 x 128 or
// 64 x 256; mgroups (1 .. ceil(M / bm)) blocks per N tile, each taking
// every mgroups-th M tile; ksplit the splits of K (1, or with mgroups = ceil(M / bm) up to one per
// 64-deep step, none empty). Scratch `partial`: (mgroups, 2, N) float32
// with one split, else (ksplit, M, N) float32. Two launches. Returns the
// first CUDA error (0 on success).
extern "C" int mmr_mm_stats(const void* x, const void* w, const void* ab, void* y,
                            void* partial, void* sums, int M, int K, int N, int relu, int bm,
                            int bn, int mgroups, int ksplit, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (ab != nullptr) {
    err = launch_mm_stats<true>(st, (const bf16*)x, (const bf16*)w, (const float*)ab, (bf16*)y,
                                (float*)partial, M, K, N, relu, bm, bn, mgroups, ksplit);
  } else {
    err = launch_mm_stats<false>(st, (const bf16*)x, (const bf16*)w, nullptr, (bf16*)y,
                                 (float*)partial, M, K, N, 0, bm, bn, mgroups, ksplit);
  }
  if (err != cudaSuccess) return (int)err;
  if (ksplit == 1) {
    return (int)reduce_partials((const float*)partial, (float*)sums, mgroups, 2LL * N, st);
  }
  return (int)split_fixup((const float*)partial, (bf16*)y, (float*)sums, M, N, ksplit, st);
}

// gy, y (M, N), x (M, K), w (N, K) bf16; gs (2, N) float32; ab (2, K) float32
// or null. Outputs: dx (M, K) bf16, dw (N, K) float32, dab (2, K) float32
// (with ab). Scratch: ge (M, N) bf16 for gy_eff; part_dw (splits, N, K)
// float32 (unused when splits == 1); with ab, part_ab (ceil(M / bm), 2, K),
// gsum_ab (ceil(ceil(M / bm) / 16), 2, K) float32 and cnt, ceil(K / bn) x
// (that group count + 1) unsigned counters (zeroed by the first launch).
// The dw kernel gives each of `splits` blocks per tile `rows_per_split`
// rows (a multiple of 64, splits * rows_per_split >= M); bm, bn in {64, 128}
// are the dx tile, tn, tk in {64, 128} the dw tile. Two launches. Returns
// the first CUDA error.
extern "C" int mmr_mm_stats_bwd(const void* gy, const void* y, const void* x, const void* w,
                                const void* gs, const void* ab, void* dx, void* dw, void* dab,
                                void* ge, void* part_dw, void* part_ab, void* gsum_ab,
                                void* cnt, int M, int K, int N, int relu, int splits,
                                int rows_per_split, int bm, int bn, int tn, int tk, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (ab != nullptr) {
    err = launch_mm_bwd<true>(st, (const bf16*)gy, (const bf16*)y, (const bf16*)x,
                              (const bf16*)w, (const float*)gs, (const float*)ab, (bf16*)dx,
                              (float*)dw, (float*)dab, (bf16*)ge, (float*)part_dw,
                              (float*)part_ab, (float*)gsum_ab, (unsigned*)cnt, M, K, N, relu,
                              splits, rows_per_split, bm, bn, tn, tk);
  } else {
    err = launch_mm_bwd<false>(st, (const bf16*)gy, (const bf16*)y, (const bf16*)x,
                               (const bf16*)w, (const float*)gs, nullptr, (bf16*)dx,
                               (float*)dw, nullptr, (bf16*)ge, (float*)part_dw, nullptr,
                               nullptr, nullptr, M, K, N, 0, splits, rows_per_split, bm, bn, tn,
                               tk);
  }
  return (int)err;
}
