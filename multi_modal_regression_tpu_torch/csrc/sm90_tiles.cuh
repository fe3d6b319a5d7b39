// Building blocks of the fused conv+BN kernels (fused_mm.cu, fused_c3.cu),
// forward and backward: a cp.async ring of shared-memory tiles, ldmatrix
// fragment loads, mma.sync m16n8k16 bf16 products with float32
// accumulation, the forward's y + statistics epilogue, the backward's dx
// epilogue, and fixed-order reductions across blocks.
//
//   ring       each operand tile is copied global -> shared by cp.async (16
//              bytes a thread, zero-filled where the chunk lies outside the
//              matrix) into one of kStages slots: loads of step k + 2 are
//              in flight while step k multiplies (the 3x3 forward has 2
//              slots, so that two of its blocks fit an SM: step k + 1's
//              loads fly). A tile that needs a transform (gy_eff from gy
//              and y, the BN prologue on x) is transformed in place by the
//              threads that copied it, after their own wait and before the
//              barrier that hands the slot to the products, so each element
//              is transformed once per slot, never once per product.
//   fragments  every operand goes through ldmatrix with one row address per
//              lane, so a shifted (3x3 tap) or masked row costs nothing: a
//              masked row points at a row of zeros in shared memory.
//   reductions per-block partials summed in a fixed order, never float
//              atomics: within a block by xor shuffles and then warps in
//              order (forward statistics), across blocks by all blocks of
//              the next launch, each a range (forward statistics, dw over
//              M splits), or by the blocks that arrive last (da, db),
//              counted with integer atomics; the order of the sums does not
//              depend on the order of arrival, so every run gives the same
//              bits.
//
// Tiles in shared memory are row-major bf16 with a row pitch of (cols + 8)
// elements: 144 bytes for 64 columns, 80 for 32, 48 for 16, so the 8 rows
// one ldmatrix reads fall on 8 different 16-byte bank groups.
#pragma once

#include <mutex>
#include <vector>

#include "fused_tiles.cuh"

namespace mmr {
namespace sm90 {

constexpr int kStages = 3;
constexpr int kGroup = 16;  // partials per group of the two-level da, db sums

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16-byte copy global -> shared; an invalid chunk is zero-filled (src is
// then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8j..8j+7 give the row addresses of matrix j.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c (16 x 8, float32) += a (16 x 16, row) * b (16 x 8, col), bf16 operands.
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Lane offsets of the four fragment loads (lane = threadIdx.x % 32). Each
// returns (row, column) within a 16 x 16 block of the STORED tile:
//   A from [m][k] (ldsm_x4):      row m, column k
//   A from [k][m] (ldsm_x4_t):    row k, column m
//   two B tiles from [k][n] (ldsm_x4_t): row k, column n; r[0], r[1] are
//   b0, b1 of columns 0-7, r[2], r[3] of columns 8-15
//   two B tiles from [n][k] (ldsm_x4):   row n, column k; r[0], r[1] are
//   b0, b1 of columns 0-7, r[2], r[3] of columns 8-15
__device__ __forceinline__ int a_row(int lane) { return lane % 16; }
__device__ __forceinline__ int a_col(int lane) { return 8 * (lane / 16); }
__device__ __forceinline__ int at_row(int lane) { return lane % 8 + 8 * (lane / 16); }
__device__ __forceinline__ int at_col(int lane) { return 8 * ((lane / 8) % 2); }
__device__ __forceinline__ int bt_row(int lane) { return lane % 8 + 8 * ((lane / 8) % 2); }
__device__ __forceinline__ int bt_col(int lane) { return 8 * (lane / 16); }
__device__ __forceinline__ int b_row(int lane) { return lane % 8 + 8 * (lane / 16); }
__device__ __forceinline__ int b_col(int lane) { return 8 * ((lane / 8) % 2); }

// gs (2, N) of the 8 channels from n, loaded once per block (a thread's
// chunks keep their channels from one ring step to the next); zeros past N.
struct Gs8 {
  float s0[8], s1[8];
};

__device__ __forceinline__ Gs8 load_gs8(const float* __restrict__ gs, int N, int n) {
  Gs8 g;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    g.s0[j] = n < N ? gs[n + j] : 0.0f;
    g.s1[j] = n < N ? gs[N + n + j] : 0.0f;
  }
  return g;
}

// gy_eff on 8 channels: (gy + gs0) + (2 y) gs1 in float32, rounded once to
// bf16, the operations of the plain version.
__device__ __forceinline__ Chunk gy_eff8(const Chunk& gy, const Chunk& y, const Gs8& g) {
  Chunk c;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float t = __fmul_rn(__fmul_rn(2.0f, __bfloat162float(y.v[j])), g.s1[j]);
    c.v[j] = __float2bfloat16_rn(__fadd_rn(__fadd_rn(__bfloat162float(gy.v[j]), g.s0[j]), t));
  }
  return c;
}

// The prologue's a, b (rounded to bf16) of the 8 channels from k, loaded
// once per block.
struct Ab8 {
  __nv_bfloat162 a[4], b[4];
};

__device__ __forceinline__ Ab8 load_ab8(const float* __restrict__ ab, int K, int k) {
  Ab8 p;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool v = ab != nullptr && k < K;
    p.a[j] = __floats2bfloat162_rn(v ? ab[k + 2 * j] : 0.0f, v ? ab[k + 2 * j + 1] : 0.0f);
    p.b[j] = __floats2bfloat162_rn(v ? ab[K + k + 2 * j] : 0.0f,
                                   v ? ab[K + k + 2 * j + 1] : 0.0f);
  }
  return p;
}

// The prologue on 8 channels. Packed bf16 arithmetic: a bf16 product is
// exact in float32 and a bf16 sum cannot land on a rounding boundary that
// float32 moves, so one rounding to bf16 (mul.rn.bf16x2, add.rn.bf16x2; the
// _rn forms are never contracted into an FMA) gives the bits of prologue_z.
__device__ __forceinline__ Chunk prologue8(Chunk c, const Ab8& p, int relu) {
  __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(c.v);
  const __nv_bfloat162 zero = __floats2bfloat162_rn(0.0f, 0.0f);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    __nv_bfloat162 z = __hadd2_rn(__hmul2_rn(v[j], p.a[j]), p.b[j]);
    if (relu) z = __hmax2_nan(z, zero);  // NaN stays NaN, as torch.relu keeps it
    v[j] = z;
  }
  return c;
}

template <int MI, int NI>
__device__ __forceinline__ void zero_acc(float (&acc)[MI][NI][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
}

// a[idx] for idx in 0..3 held in registers (no local-memory indexing).
__device__ __forceinline__ unsigned sel4(unsigned a0, unsigned a1, unsigned a2, unsigned a3,
                                         int idx) {
  return idx == 0 ? a0 : idx == 1 ? a1 : idx == 2 ? a2 : a3;
}

// The forward's per-tile epilogue, for a warp that holds rows r0.. (32 of
// them, MI = 2 m16 tiles) and columns c0.. (8 NI) of the BM x BN tile at
// (m0, n0) of the (M, N) output as acc[2][NI][4]:
//   y = bf16(acc), rounded in registers and written in 16-byte chunks
//   straight from them: for each m16 tile and pair of n8 tiles, the 4
//   lanes of a quad swap their bf16 pairs (3 xor shuffles) so that lanes
//   0, 1 hold the two halves of one row's 32-byte sector and lanes 2, 3 the
//   row 8 below (rows < M, columns < N);
//   the tile's (sum y, sum y^2) of the ROUNDED values per column, over the
//   warp's rows in order and across its 8 row groups by xor shuffles (every
//   lane ends with the same bits), added to this warp's running sums
//   sRed[wr][2][BN] by the one lane that owns each column (no other thread
//   touches it): the same bits on every run.
template <int NI, int BN>
__device__ __forceinline__ void y_stats_tile(const float (&acc)[2][NI][4], bf16* __restrict__ y,
                                             float* sRed, int wr, int r0, int c0, int m0,
                                             int n0, int M, int N) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    float s0 = 0.0f, s1 = 0.0f, q0 = 0.0f, q1 = 0.0f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the m16 tile
        if (m0 + r0 + 16 * i + 8 * h + g < M) {
          const __nv_bfloat162 v =
              __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
          const float y0 = __low2float(v), y1 = __high2float(v);
          s0 += y0;
          s1 += y1;
          q0 += y0 * y0;
          q1 += y1 * y1;
        }
      }
    }
#pragma unroll
    for (int off = 4; off < 32; off *= 2) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      q0 += __shfl_xor_sync(0xffffffffu, q0, off);
      q1 += __shfl_xor_sync(0xffffffffu, q1, off);
    }
    if (g == 0) {
      float2* ps = reinterpret_cast<float2*>(sRed + (wr * 2 + 0) * BN + c0 + 8 * j + 2 * t);
      float2* pq = reinterpret_cast<float2*>(sRed + (wr * 2 + 1) * BN + c0 + 8 * j + 2 * t);
      const float2 a = *ps, b = *pq;
      *ps = make_float2(a.x + s0, a.y + s1);
      *pq = make_float2(b.x + q0, b.y + q1);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int jj = 0; jj < NI / 2; ++jj) {
      // item e = 2 h + js: row r0 + 16 i + 8 h + g, columns c0 + 8 (2 jj + js)
      // + 2 t, +1 in this lane; after the swap, lane t holds all 8 columns
      // of item t
      unsigned v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 b = __floats2bfloat162_rn(acc[i][2 * jj + e % 2][2 * (e / 2)],
                                                       acc[i][2 * jj + e % 2][2 * (e / 2) + 1]);
        v[e] = *reinterpret_cast<const unsigned*>(&b);
      }
      unsigned r[4];  // r[k]: columns 2 (t ^ k).. of item t, from lane t ^ k
      r[0] = sel4(v[0], v[1], v[2], v[3], t);
#pragma unroll
      for (int k = 1; k < 4; ++k) {
        r[k] = __shfl_xor_sync(0xffffffffu, sel4(v[0], v[1], v[2], v[3], t ^ k), k);
      }
      const int row = m0 + r0 + 16 * i + 8 * (t / 2) + g;
      const int col = n0 + c0 + 8 * (2 * jj + t % 2);
      if (row < M && col < N) {
        uint4 out;
        out.x = sel4(r[0], r[1], r[2], r[3], 0 ^ t);
        out.y = sel4(r[0], r[1], r[2], r[3], 1 ^ t);
        out.z = sel4(r[0], r[1], r[2], r[3], 2 ^ t);
        out.w = sel4(r[0], r[1], r[2], r[3], 3 ^ t);
        *reinterpret_cast<uint4*>(y + (long long)row * N + col) = out;
      }
    }
  }
}

// A warp's acc[2][NI][4] (rows r0 + 16 i + g and + 8, columns c0 + 8 j +
// 2 t, +1) as float32 into out (M, N), rows < M; N is a multiple of 8.
template <int NI>
__device__ __forceinline__ void store_acc_f32(const float (&acc)[2][NI][4],
                                              float* __restrict__ out, int r0, int c0, int M,
                                              int N) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int row = r0 + 16 * i + g, col = c0 + 8 * j + 2 * t;
      if (col >= N) continue;
      if (row < M) {
        *reinterpret_cast<float2*>(out + (long long)row * N + col) =
            make_float2(acc[i][j][0], acc[i][j][1]);
      }
      if (row + 8 < M) {
        *reinterpret_cast<float2*>(out + (long long)(row + 8) * N + col) =
            make_float2(acc[i][j][2], acc[i][j][3]);
      }
    }
  }
}

// The block's statistics partial: the WR warps' running sums sRed[WR][2][BN]
// summed in order into partial[(p * 2 + which) * N + n0 + col], 256
// threads, after a barrier that follows the last y_stats_tile.
template <int WR, int BN>
__device__ __forceinline__ void write_stats_partial(const float* sRed, float* __restrict__ partial,
                                                    int p, int n0, int N) {
  for (int i = threadIdx.x; i < 2 * BN; i += 256) {
    const int which = i / BN, col = i % BN;
    if (n0 + col < N) {
      float s = 0.0f;
#pragma unroll
      for (int r = 0; r < WR; ++r) s += sRed[(r * 2 + which) * BN + col];
      partial[((long long)p * 2 + which) * N + n0 + col] = s;
    }
  }
}

// Stage a warp's accumulators acc[MI][NI][4] (m16 x n8 tiles at rows r0 +
// 16 i, columns c0 + 8 j) as floats into sC[row * ldc + col].
template <int MI, int NI>
__device__ __forceinline__ void stage_acc(float* sC, int ldc, const float (&acc)[MI][NI][4],
                                          int r0, int c0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      float* p = sC + (r0 + 16 * i + g) * ldc + c0 + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(p) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(p + 8 * ldc) = make_float2(acc[i][j][2], acc[i][j][3]);
    }
  }
}

// The dx epilogue over the staged dxh tile sC (BM x BN, pitch BN + 4; rows
// m0.., input channels k0..), 256 threads. PRO: dz = dxh masked by the
// recomputed z > 0 (with relu), dx = bf16(dz * a), and the block's
// (sum dz * x, sum dz) per channel into partial (mtiles, 2, K) at mt,
// summed over the row groups in order through sRed (256 / (BN / 8) x 2 x BN
// floats). Otherwise dx = bf16(dxh). The bits of each dx element are those
// of the first design: the same float32 operations per element.
template <bool PRO, int BM, int BN>
__device__ __forceinline__ void dx_epilogue(const float* sC, float* sRed,
                                            const bf16* __restrict__ x,
                                            const float* __restrict__ ab,
                                            bf16* __restrict__ dx, float* __restrict__ partial,
                                            int mt, int m0, int k0, int M, int K, int relu) {
  constexpr int kCpr = BN / 8, kRg = 256 / kCpr, kLdc = BN + 4;
  const int cc = threadIdx.x % kCpr, rg = threadIdx.x / kCpr;
  const int gk = k0 + 8 * cc;
  float s[8], q[8], a[8], ar[8], br[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j] = 0.0f;
    q[j] = 0.0f;
    a[j] = 1.0f;
    ar[j] = 1.0f;
    br[j] = 0.0f;
  }
  if (gk < K) {
    if (PRO) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        a[j] = ab[gk + j];
        ar[j] = round_to<bf16>(a[j]);
        br[j] = round_to<bf16>(ab[K + gk + j]);
      }
    }
    for (int r = rg; r < BM; r += kRg) {
      const int gm = m0 + r;
      if (gm >= M) break;
      const float4 v0 = *reinterpret_cast<const float4*>(sC + r * kLdc + 8 * cc);
      const float4 v1 = *reinterpret_cast<const float4*>(sC + r * kLdc + 8 * cc + 4);
      float d[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
      Chunk out;
      if (PRO) {
        const Chunk xc = load_chunk(x + (long long)gm * K + gk);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xv = __bfloat162float(xc.v[j]);
          if (relu && !(prologue_z(xv, ar[j], br[j]) > 0.0f)) d[j] = 0.0f;
          s[j] += d[j] * xv;
          q[j] += d[j];
          out.v[j] = __float2bfloat16_rn(__fmul_rn(d[j], a[j]));
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) out.v[j] = __float2bfloat16_rn(d[j]);
      }
      store_chunk(dx + (long long)gm * K + gk, out);
    }
  }
  if (!PRO) return;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sRed[(rg * 2 + 0) * BN + 8 * cc + j] = s[j];
    sRed[(rg * 2 + 1) * BN + 8 * cc + j] = q[j];
  }
  __syncthreads();
  if (threadIdx.x < 2 * BN) {
    const int which = threadIdx.x / BN, col = threadIdx.x % BN;
    if (k0 + col < K) {
      float t = 0.0f;
      for (int r = 0; r < kRg; ++r) t += sRed[(r * 2 + which) * BN + col];
      partial[((long long)mt * 2 + which) * K + k0 + col] = t;
    }
  }
}

// Called by every block of one column tile (columns [c0, c0 + nc) of the
// (P, 2, K) partials, block p) after its partial is written. The last block
// of each group of kGroup partials sums the group in order into gsum
// (ngroups, 2, K); the last group's last block sums the groups in order
// into out (2, K). cnt holds ngroups + 1 counters for this column tile,
// zero on entry; they are left zero.
__device__ __forceinline__ void reduce_dab_tail(const float* part, float* gsum, float* out,
                                                unsigned* cnt, int P, int p, int K, int c0,
                                                int nc) {
  __shared__ unsigned s_last;
  const int g = p / kGroup, ngroups = (P + kGroup - 1) / kGroup;
  const int gsize = min(kGroup, P - g * kGroup);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&cnt[g], 1u) == (unsigned)(gsize - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < 2 * nc; i += blockDim.x) {
    const int r = i / nc, c = c0 + i % nc;
    float t = 0.0f;
    for (int j = g * kGroup; j < g * kGroup + gsize; ++j) {
      t += __ldcg(part + ((long long)j * 2 + r) * K + c);
    }
    gsum[((long long)g * 2 + r) * K + c] = t;
  }
  if (threadIdx.x == 0) cnt[g] = 0;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&cnt[ngroups], 1u) == (unsigned)(ngroups - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < 2 * nc; i += blockDim.x) {
    const int r = i / nc, c = c0 + i % nc;
    float t = 0.0f;
    for (int j = 0; j < ngroups; ++j) t += __ldcg(gsum + ((long long)j * 2 + r) * K + c);
    out[r * K + c] = t;
  }
  if (threadIdx.x == 0) cnt[ngroups] = 0;
}

// out[i] = sum over j of part[j * L + i] for i in [lo, hi), 256 threads.
// Under 16 partials each thread sums whole columns in order; from 16 on, 8
// interleaved subsets of the partials are summed in order and then the 8
// sums in order (128 columns at a time), so that a column's loads are in
// flight together. Either way the order depends on P alone, not on which
// block sums which range. lo is a multiple of 4, as is L; s holds 8 x 128
// floats.
__device__ __forceinline__ void reduce_range(const float* part, float* out, int P, long long L,
                                             long long lo, long long hi, float* s) {
  if (P < 16) {
    for (long long i = lo + 4 * threadIdx.x; i < hi; i += 4 * blockDim.x) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
      for (int j = 0; j < P; ++j) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(part + (long long)j * L + i));
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      *reinterpret_cast<float4*>(out + i) = acc;
    }
    return;
  }
  const int lane = threadIdx.x % 32, rg = threadIdx.x / 32;
  for (long long base = lo; base < hi; base += 128) {
    const long long i = base + 4 * lane;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (i < hi) {
#pragma unroll 4
      for (int j = rg; j < P; j += 8) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(part + (long long)j * L + i));
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
    }
    *reinterpret_cast<float4*>(s + rg * 128 + 4 * lane) = acc;
    __syncthreads();
    if (rg == 0 && i < hi) {
      float4 t = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(s + r * 128 + 4 * lane);
        t.x += v.x;
        t.y += v.y;
        t.z += v.z;
        t.w += v.w;
      }
      *reinterpret_cast<float4*>(out + i) = t;
    }
    __syncthreads();
  }
}

// This block's share of summing the (P, L) dw partials: all blocks of the
// grid split L into equal ranges.
__device__ __forceinline__ void reduce_dw_share(const float* part, float* out, int P,
                                                long long L, float* s) {
  const long long per = ((L / 4 + gridDim.x - 1) / gridDim.x) * 4;
  const long long lo = (long long)blockIdx.x * per;
  reduce_range(part, out, P, L, lo, lo + per < L ? lo + per : L, s);
}

// Allow `bytes` of dynamic shared memory for kernel fn on the current device
// (needed above 48 KB). The attribute holds for the life of the process, so
// it is set once per kernel and device, and again only for a larger size.
inline cudaError_t allow_smem_once(const void* fn, int bytes) {
  struct Allowed {
    const void* fn;
    int device, bytes;
  };
  static std::mutex mu;
  static std::vector<Allowed> allowed;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  Allowed* seen = nullptr;
  for (Allowed& a : allowed) {
    if (a.fn == fn && a.device == device) seen = &a;
  }
  if (seen != nullptr && bytes <= seen->bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  if (seen != nullptr) {
    seen->bytes = bytes;
  } else {
    allowed.push_back({fn, device, bytes});
  }
  return cudaSuccess;
}

template <typename F>
inline cudaError_t allow_smem(F* fn, int bytes) {
  return allow_smem_once((const void*)fn, bytes);
}

}  // namespace sm90
}  // namespace mmr
