// Pose-bin assignment: out[i] = argmin_k (|c_k|^2 - 2 y_i . c_k), int32.
//
// Replaces the TPU kernel in the JAX package's ops/assign.py
// `_pallas_assign` (body `_kernel`), which streams 1024-row tiles of y
// through fast memory with the centers and their squared norms resident and
// fuses the distance with the argmin, so that no (N, K) matrix is ever
// written to device memory. |y_i|^2 is constant per row and is dropped.
//
// Bound on the H100: instruction issue. A row is D floats in and one int32
// out (16 bytes at D = 3) for K distances: at (2,000,000, 3) x 200 the bytes
// take 0.0096 ms at 3.35 TB/s, the 4e8 (row, center) pairs several times
// that. Each pair costs D multiplies and D - 1 adds that must be rounded one
// by one (below), so every float32 operation takes an issue slot of its own
// and the card's fused multiply-add rate is out of reach: the floor is the
// pairs' instructions over 132 SMs x 4 issue slots a cycle. The design
// spends as few slots a pair as the arithmetic allows:
//   - Persistent blocks (ops/assign._assign_plan: blocks an SM x SMs, all
//     resident at once, or fewer where the rows are few; 3 an SM, 2 at
//     D = 4 for the registers of its rows). Block b takes the
//     warp tiles [T b / G, T (b + 1) / G) of all T, so every SM gets the same
//     number of rows. A block reads the K centers once, forms their squared
//     norms once, and packs each center with its norm into one 16-byte
//     shared-memory slot (two at D = 4): one broadcast read a center.
//   - R = 8 rows a thread: a warp tile is 256 rows, lane l takes rows l,
//     l + 32, ..., l + 224, so loads and stores coalesce, and each center
//     read from shared memory serves 8 rows.
//   - The fast loop, for a warp whose rows are all finite with |v| < 2^60,
//     in a block whose center coordinates all are (a flag in shared memory,
//     __syncthreads_and). Then every product is below 2^120 in magnitude and
//     c2, the cross term and 2 * cross are finite, so no distance is NaN and
//     doubling is exact, subnormals included: __fmaf_rn(-2, cross, c2)
//     equals __fsub_rn(c2, __fmul_rn(2, cross)) bit for bit, one slot
//     instead of two. The centers go in groups of 4: the group's minimum
//     (3 min instructions) against the row's best (a compare and two
//     selects) costs 6 slots a group where a compare per center costs 12.
//     The strict `<` keeps the first group that holds the row's minimum;
//     at the end the row walks that group again, with the same instructions
//     and so the same bits, to the first center at the minimum: torch.argmin's
//     first minimum. A pair costs 3 FMUL, 2 FADD, 1 FFMA (D = 3) and 1.5
//     slots of the argmin, plus 1/R of a shared-memory read.
//   - The careful loop, today's arithmetic and NaN rule unchanged, for a
//     warp that holds a row outside the guard (NaN, inf, |v| >= 2^60) and
//     for every warp of a block whose centers fail it. It is the same kernel
//     and gives the same bits as the fast loop where both apply; only speed
//     depends on which loop a warp takes.
// Tensor cores cannot form this cross term: their products sum in a wider
// accumulator and round once, where the reference rounds each product and
// each partial sum to float32 on its own, and a different rounding moves a
// near tie to another index.
//
// Arithmetic, chosen so that the kernel and its plain PyTorch version
// (ops/assign.assign_bins_plain) give the same indices: products and sums
// are rounded one by one (__fmul_rn/__fadd_rn/__fsub_rn, never a contracted
// FMA in the cross term), the cross term and the squared norms are summed
// over d in index order, and the distance is c2 - 2 * cross. Ties keep the
// lowest index. A NaN distance wins its row and the first NaN keeps it, as
// torch.argmin and jnp.argmin have it.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "sm90_tiles.cuh"  // allow_smem_once

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // rows a thread: a warp tile of 256 (ops/assign.py _TILE_ROWS)
// blocks an SM (ops/assign._assign_plan): 3, so 80 registers a thread;
// 2 at D = 4, whose 8 rows of 4 values spill at 80
template <int D> __host__ __device__ constexpr int per_sm() { return D < 4 ? 3 : 2; }
constexpr int kGroup = 4;  // centers a group of the fast loop
constexpr float kGuard = 1152921504606846976.0f;  // 2^60

// 16-byte slots a center takes in shared memory: D coordinates and the norm
template <int D> __host__ __device__ constexpr int slots() { return D < 4 ? 1 : 2; }

template <int D>
struct Center {
  float c[D];
  float c2;
};

template <int D>
__device__ __forceinline__ Center<D> load_center(const float4* sc, int j) {
  const float4 a = sc[j * slots<D>()];
  float f[8] = {a.x, a.y, a.z, a.w, 0.0f, 0.0f, 0.0f, 0.0f};
  if (slots<D>() == 2) f[4] = sc[j * 2 + 1].x;
  Center<D> out;
#pragma unroll
  for (int d = 0; d < D; ++d) out.c[d] = f[d];
  out.c2 = f[D];
  return out;
}

// the cross term y . c, summed over d in order, each product and sum rounded
template <int D>
__device__ __forceinline__ float cross_term(const float (&v)[D], const Center<D>& c) {
  float s = __fmul_rn(v[0], c.c[0]);
#pragma unroll
  for (int d = 1; d < D; ++d) s = __fadd_rn(s, __fmul_rn(v[d], c.c[d]));
  return s;
}

// c2 - 2 cross, exact doubling and one rounding: only under the guard
template <int D>
__device__ __forceinline__ float fast_dist(const float (&v)[D], const Center<D>& c) {
  return __fmaf_rn(-2.0f, cross_term<D>(v, c), c.c2);
}

template <int D>
__device__ __forceinline__ float careful_dist(const float (&v)[D], const Center<D>& c) {
  return __fsub_rn(c.c2, __fmul_rn(2.0f, cross_term<D>(v, c)));
}

template <int D>
__device__ __forceinline__ void fast_rows(const float4* sc, int k, const float (&v)[kRows][D],
                                          int (&idx)[kRows]) {
  float best[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    best[r] = INFINITY;
    idx[r] = 0;  // the first center of the group that holds the minimum
  }
  const int k4 = k - k % kGroup;
  int j = 0;
  for (; j < k4; j += kGroup) {
    float m[kRows];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const Center<D> c = load_center<D>(sc, j + u);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float dist = fast_dist<D>(v[r], c);
        m[r] = u == 0 ? dist : fminf(m[r], dist);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (m[r] < best[r]) {
        best[r] = m[r];
        idx[r] = j;
      }
    }
  }
  for (; j < k; ++j) {  // the last k % 4 centers, a group of one each
    const Center<D> c = load_center<D>(sc, j);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float dist = fast_dist<D>(v[r], c);
      if (dist < best[r]) {
        best[r] = dist;
        idx[r] = j;
      }
    }
  }
  // the first center of the winning group at the minimum (the group holds it)
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int last = min(idx[r] + kGroup, k) - 1;
    int i = idx[r];
    while (i < last && fast_dist<D>(v[r], load_center<D>(sc, i)) != best[r]) ++i;
    idx[r] = i;
  }
}

template <int D>
__device__ __forceinline__ void careful_rows(const float4* sc, int k, const float (&v)[kRows][D],
                                             int (&idx)[kRows]) {
  float best[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    best[r] = 0.0f;
    idx[r] = 0;
  }
  for (int j = 0; j < k; ++j) {
    const Center<D> c = load_center<D>(sc, j);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float dist = careful_dist<D>(v[r], c);
      // the first center starts the minimum; later a smaller distance takes
      // it, and so does a NaN unless a NaN holds it already
      if (j == 0 || dist < best[r] || (dist != dist && best[r] == best[r])) {
        best[r] = dist;
        idx[r] = j;
      }
    }
  }
}

__device__ __forceinline__ bool in_guard(float v) { return fabsf(v) < kGuard; }

template <int D>
__global__ void __launch_bounds__(kThreads, per_sm<D>())
    assign_kernel(const float* __restrict__ y, const float* __restrict__ centers,
                  int32_t* __restrict__ out, long long n, int k, long long tiles) {
  extern __shared__ float4 sc[];  // K centers, slots<D>() 16-byte slots each
  bool ok = true;
  for (int j = threadIdx.x; j < k; j += kThreads) {
    float f[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int d = 0; d < D; ++d) {
      f[d] = centers[j * D + d];
      ok = ok && in_guard(f[d]);
    }
    float s = __fmul_rn(f[0], f[0]);
#pragma unroll
    for (int d = 1; d < D; ++d) s = __fadd_rn(s, __fmul_rn(f[d], f[d]));
    f[D] = s;
    sc[j * slots<D>()] = make_float4(f[0], f[1], f[2], f[3]);
    if (slots<D>() == 2) sc[j * 2 + 1] = make_float4(f[4], f[5], f[6], f[7]);
  }
  const bool centers_ok = __syncthreads_and(ok);

  // this block's warp tiles, walked by its warps in turn
  const long long t0 = tiles * blockIdx.x / gridDim.x;
  const long long t1 = tiles * (blockIdx.x + 1) / gridDim.x;
  const int lane = threadIdx.x % 32;
  for (long long t = t0 + threadIdx.x / 32; t < t1; t += kThreads / 32) {
    const long long base = t * (32 * kRows);  // 64-bit base, 32-bit offsets below
    const float* yt = y + base * D;
    const long long left_ll = n - base;
    const int left = left_ll < 32 * kRows ? (int)left_ll : 32 * kRows;  // rows of this tile
    float v[kRows][D];
    bool mine = true;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = lane + 32 * r;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        v[r][d] = i < left ? yt[i * D + d] : 0.0f;
        mine = mine && in_guard(v[r][d]);
      }
    }
    int idx[kRows];
    if (__all_sync(0xffffffffu, mine) && centers_ok) {
      fast_rows<D>(sc, k, v, idx);
    } else {
      careful_rows<D>(sc, k, v, idx);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = lane + 32 * r;
      if (i < left) out[base + i] = idx[r];
    }
  }
}

template <int D>
cudaError_t launch(const float* y, const float* c, int32_t* out, long long n, int k,
                   long long tiles, int blocks, int smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t err = mmr::sm90::allow_smem(assign_kernel<D>, smem);
    if (err != cudaSuccess) return err;
  }
  assign_kernel<D><<<blocks, kThreads, smem, st>>>(y, c, out, n, k, tiles);
  return cudaGetLastError();
}

}  // namespace

// y (n, d) float32, centers (k, d) float32, out (n,) int32, all contiguous;
// d in 1..4, k >= 1. The launch shape comes from ops/assign._assign_plan:
// `blocks` blocks of 256 threads walking `tiles` warp tiles of 256 rows
// (8 rows a thread), `smem` bytes of dynamic shared memory (k slots of 16
// bytes, 32 at d = 4). Returns cudaGetLastError()
// after the launch (0 on success), cudaErrorInvalidValue for a shape the
// kernel does not take.
extern "C" int mmr_assign(const void* y, const void* centers, void* out, long long n, int d,
                          int k, int blocks, long long tiles, int smem, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const long long slot_bytes = d < 4 ? 16 : 32;
  if (k < 1 || d < 1 || d > 4 || blocks < 1 || (long long)smem != k * slot_bytes ||
      smem > 227 * 1024 || tiles != (n + 32LL * kRows - 1) / (32LL * kRows) || blocks > tiles) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const float* yy = (const float*)y;
  const float* cc = (const float*)centers;
  int32_t* oo = (int32_t*)out;
  switch (d) {
    case 1: return (int)launch<1>(yy, cc, oo, n, k, tiles, blocks, smem, st);
    case 2: return (int)launch<2>(yy, cc, oo, n, k, tiles, blocks, smem, st);
    case 3: return (int)launch<3>(yy, cc, oo, n, k, tiles, blocks, smem, st);
    default: return (int)launch<4>(yy, cc, oo, n, k, tiles, blocks, smem, st);
  }
}
