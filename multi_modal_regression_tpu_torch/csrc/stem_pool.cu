// ResNet stem tail: p = maxpool3x3/2 pad 1(relu(y * a + b)), forward and backward.
//
// Forward: replaces the TPU kernel in the JAX package's ops/stem_pool.py
// `_stem_fwd` (body `_fwd_kernel`). Backward: replaces `_stem_bwd` (body
// `_bwd_kernel`); see stem_bwd_kernel below. a, b are the folded BN affine
// (ops/fused_conv_bn.fold_bn, from running statistics in eval mode and
// from batch statistics in training), float32 per channel.
//
// Layout: y is (B, H, W, C) in memory, i.e. a (B, C, H, W) tensor in
// torch.channels_last, the format the trunk's conv1 writes; p is
// (B, H/2, W/2, C) in memory, also channels_last. H and W are even.
//
// Bound on the H100: memory. Each output reads a 3x3 window of y and does
// ~4 flops per tap; y is read once from DRAM (64x112x112x64 bf16 = 103 MB
// for the serving batch) and p written once (26 MB). The unfused plain
// version makes three passes (affine, ReLU, pool) and writes two
// full-size intermediates. The design: one thread per output element,
// neighbouring threads on neighbouring channels, so each of the 9 taps is
// a coalesced read of C contiguous values; the overlapping windows of
// neighbouring outputs are served from L1/L2, so DRAM sees each input byte
// about once. Shared-memory tiling and vector loads are left for a later
// change.
//
// Padding is zero, which is exact: every tap is post-ReLU (>= 0) and no
// window is all padding. Rounding follows PyTorch's eager ops, so the
// result is bit-identical to the plain version: in bf16, a and b are first
// rounded to bf16 (as the TPU kernel does), and the product and the sum are
// each rounded to bf16; in f32 the product and the sum are rounded
// separately (__fmul_rn/__fadd_rn, never a contracted FMA).
// NaN: propagated, as torch.relu and max_pool2d propagate it (fmaxf would
// drop it).

#include <stdint.h>

#include "common.cuh"

namespace {

template <typename T>
__global__ void stem_fwd_kernel(const T* __restrict__ y, const float* __restrict__ a,
                                const float* __restrict__ b, T* __restrict__ out,
                                int B, int H, int W, int C) {
  const int OH = H / 2, OW = W / 2;
  const long long total = (long long)B * OH * OW * C;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const int c = (int)(i % C);
    long long r = i / C;
    const int ow = (int)(r % OW);
    r /= OW;
    const int oh = (int)(r % OH);
    const long long n = r / OH;
    const float ac = mmr::round_to<T>(a[c]);
    const float bc = mmr::round_to<T>(b[c]);
    float m = 0.0f;
    for (int dh = -1; dh <= 1; ++dh) {
      const int h = 2 * oh + dh;
      if (h < 0 || h >= H) continue;
      const T* row = y + ((n * H + h) * W) * (long long)C + c;
      for (int dw = -1; dw <= 1; ++dw) {
        const int w = 2 * ow + dw;
        if (w < 0 || w >= W) continue;
        const float v = mmr::to_float<T>(row[(long long)w * C]);
        float z = mmr::round_to<T>(__fadd_rn(mmr::round_to<T>(__fmul_rn(v, ac)), bc));
        z = z < 0.0f ? 0.0f : z;        // ReLU; NaN stays NaN
        if (m == m && !(z <= m)) m = z;  // max; once NaN, stays NaN
      }
    }
    out[i] = mmr::from_float<T>(m);
  }
}

// relu(y * a + b) of one element, rounded exactly as the forward rounds it.
template <typename T>
__device__ __forceinline__ float stem_z(const T* __restrict__ y, long long idx, float ac,
                                        float bc) {
  const float v = mmr::to_float<T>(y[idx]);
  const float z = mmr::round_to<T>(__fadd_rn(mmr::round_to<T>(__fmul_rn(v, ac)), bc));
  return z < 0.0f ? 0.0f : z;  // NaN stays NaN
}

// Backward of the stem tail. Given g = dL/dp (B, H/2, W/2, C), y and a, b:
//   dy = route(g) * relu_mask * a      (in y's dtype, rounded once)
//   da = sum gz * y,  db = sum gz      (float32, over B, H, W)
// where gz = route(g) * relu_mask and route sends each pooled gradient to
// its window's argmax. Two kernels:
//
// stem_argmax_kernel, one thread per pooled output (c fastest, like the
// forward): recomputes the window's 9 taps and stores which tap is its
// argmax (0..8, row-major from the unclipped window origin) in one byte.
// The rule is torch's max_pool2d rule (row-major scan, strictly greater
// replaces, a NaN always replaces), so the kernel routes exactly as its
// plain version (autograd of the three eager ops). The JAX kernel's
// factorized column-then-row rule differs from it only at positive bf16
// ties across two window columns.
//
// stem_bwd_kernel, gather, not scatter: one thread per input element,
// which reads the argmax bytes of the at most 2 x 2 pooled windows that
// contain it and adds g where the argmax is this element. No atomics; dy
// is deterministic. Elements whose pre-activation is <= 0 get dy = 0 (the
// ReLU mask is taken from the same rounded affine as the forward; a NaN
// passes it, as in torch's ReLU backward).
//
// da, db: each block reduces its threads' per-channel sums in a fixed
// order into partial[blockIdx.y] (a (nblk, 2, C) float32 buffer), and
// stem_bwd_finalize sums the nblk partials in order: the same inputs give
// the same bits on every run.
//
// Bound on the H100: memory. The argmax pass reads y about once (the
// windows overlap in L1/L2) and writes a byte per pooled output; the gather
// pass reads y, the argmax bytes and g (each pooled value by up to 4
// threads, from cache) and writes dy: about 12 bytes per input element in
// bf16 over the two passes. Gather block: 32 channels (one warp reads 32
// contiguous values of a pixel) x 8 pixel rows; each thread walks a
// grid-stride loop over pixels and keeps its channel, so its partial sums
// stay in registers.
constexpr int kBwdChannels = 32;
constexpr int kBwdRows = 8;

template <typename T>
__global__ void stem_argmax_kernel(const T* __restrict__ y, const float* __restrict__ a,
                                   const float* __restrict__ b, uint8_t* __restrict__ arg,
                                   int B, int H, int W, int C) {
  const int OH = H / 2, OW = W / 2;
  const long long total = (long long)B * OH * OW * C;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const int c = (int)(i % C);
    long long r = i / C;
    const int ow = (int)(r % OW);
    r /= OW;
    const int oh = (int)(r % OH);
    const long long n = r / OH;
    const float ac = mmr::round_to<T>(a[c]);
    const float bc = mmr::round_to<T>(b[c]);
    const T* yn = y + n * H * (long long)W * C + c;
    float m = -__int_as_float(0x7f800000);  // -inf
    int best = 0;
    for (int dh = 0; dh < 3; ++dh) {
      const int h = 2 * oh - 1 + dh;
      if (h < 0 || h >= H) continue;
      for (int dw = 0; dw < 3; ++dw) {
        const int w = 2 * ow - 1 + dw;
        if (w < 0 || w >= W) continue;
        const float v = stem_z<T>(yn, ((long long)h * W + w) * C, ac, bc);
        if (v > m || v != v) {
          m = v;
          best = dh * 3 + dw;
        }
      }
    }
    arg[i] = (uint8_t)best;
  }
}

template <typename T>
__global__ void stem_bwd_kernel(const T* __restrict__ g, const T* __restrict__ y,
                                const float* __restrict__ a, const float* __restrict__ b,
                                const uint8_t* __restrict__ arg, T* __restrict__ dy,
                                float* __restrict__ partial, int B, int H, int W, int C) {
  const int OH = H / 2, OW = W / 2;
  const int c = blockIdx.x * kBwdChannels + threadIdx.x;
  const bool active = c < C;
  const float a_f = active ? a[c] : 0.0f;
  const float ac = mmr::round_to<T>(a_f);
  const float bc = active ? mmr::round_to<T>(b[c]) : 0.0f;
  float da = 0.0f, db = 0.0f;
  const long long P = (long long)B * H * W;
  if (active) {
    for (long long p = (long long)blockIdx.y * kBwdRows + threadIdx.y; p < P;
         p += (long long)gridDim.y * kBwdRows) {
      const int w = (int)(p % W);
      const int h = (int)((p / W) % H);
      const long long n = p / ((long long)W * H);
      const long long idx = p * C + c;
      const float z = stem_z<T>(y, idx, ac, bc);
      float gz = 0.0f;
      if (!(z <= 0.0f)) {  // ReLU mask; NaN passes
        const long long base = n * OH * (long long)OW * C + c;
        const int oh_hi = min(OH - 1, (h + 1) / 2), ow_hi = min(OW - 1, (w + 1) / 2);
        for (int oh = h / 2; oh <= oh_hi; ++oh) {
          for (int ow = w / 2; ow <= ow_hi; ++ow) {
            const long long o = base + ((long long)oh * OW + ow) * C;
            if (arg[o] == (h - 2 * oh + 1) * 3 + (w - 2 * ow + 1)) {
              gz += mmr::to_float<T>(g[o]);
            }
          }
        }
      }
      dy[idx] = mmr::from_float<T>(gz * a_f);
      da += gz * mmr::to_float<T>(y[idx]);
      db += gz;
    }
  }
  __shared__ float s_da[kBwdRows][kBwdChannels];
  __shared__ float s_db[kBwdRows][kBwdChannels];
  s_da[threadIdx.y][threadIdx.x] = da;
  s_db[threadIdx.y][threadIdx.x] = db;
  __syncthreads();
  if (threadIdx.y == 0 && active) {
    float sa = 0.0f, sb = 0.0f;
    for (int r = 0; r < kBwdRows; ++r) {
      sa += s_da[r][threadIdx.x];
      sb += s_db[r][threadIdx.x];
    }
    partial[((long long)blockIdx.y * 2 + 0) * C + c] = sa;
    partial[((long long)blockIdx.y * 2 + 1) * C + c] = sb;
  }
}

// dab[k][c] = sum over j of partial[j][k][c], j in order.
__global__ void stem_bwd_finalize(const float* __restrict__ partial, float* __restrict__ dab,
                                  int nblk, int C) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < 2 * C; i += gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int j = 0; j < nblk; ++j) s += partial[(long long)j * 2 * C + i];
    dab[i] = s;
  }
}

}  // namespace

// is_bf16: 0 -> float32 y and out, 1 -> bfloat16 y and out; a, b float32 (C,).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mmr_stem_fwd(const void* y, const void* a, const void* b, void* out,
                            int B, int H, int W, int C, int is_bf16,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)B * (H / 2) * (W / 2) * C;
  if (total <= 0) return 0;
  const int threads = 256;
  const unsigned int blocks = mmr::grid_for(total, threads);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    stem_fwd_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)y, (const float*)a, (const float*)b, (__nv_bfloat16*)out,
        B, H, W, C);
  } else {
    stem_fwd_kernel<float><<<blocks, threads, 0, st>>>(
        (const float*)y, (const float*)a, (const float*)b, (float*)out, B, H, W, C);
  }
  return (int)cudaGetLastError();
}

// g (B, H/2, W/2, C) and y, dy (B, H, W, C) in y's dtype (is_bf16 as above);
// a, b float32 (C,); arg uint8 (B, H/2, W/2, C) and partial float32
// (nblk, 2, C) scratch; dab float32 (2, C) gets (da, db). nblk (>= 1) is the
// gather grid's pixel dimension, chosen by the caller, which allocates the
// scratch. Returns the first CUDA error (0 on success).
extern "C" int mmr_stem_bwd(const void* g, const void* y, const void* a, const void* b,
                            void* dy, void* arg, void* partial, void* dab, int B, int H,
                            int W, int C, int nblk, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long outputs = (long long)B * (H / 2) * (W / 2) * C;
  if (outputs <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  const unsigned int arg_blocks = mmr::grid_for(outputs, threads);
  const dim3 block(kBwdChannels, kBwdRows);
  const dim3 grid((C + kBwdChannels - 1) / kBwdChannels, nblk);
  if (is_bf16) {
    using T = __nv_bfloat16;
    stem_argmax_kernel<T><<<arg_blocks, threads, 0, st>>>(
        (const T*)y, (const float*)a, (const float*)b, (uint8_t*)arg, B, H, W, C);
    stem_bwd_kernel<T><<<grid, block, 0, st>>>(
        (const T*)g, (const T*)y, (const float*)a, (const float*)b, (const uint8_t*)arg,
        (T*)dy, (float*)partial, B, H, W, C);
  } else {
    stem_argmax_kernel<float><<<arg_blocks, threads, 0, st>>>(
        (const float*)y, (const float*)a, (const float*)b, (uint8_t*)arg, B, H, W, C);
    stem_bwd_kernel<float><<<grid, block, 0, st>>>(
        (const float*)g, (const float*)y, (const float*)a, (const float*)b,
        (const uint8_t*)arg, (float*)dy, (float*)partial, B, H, W, C);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stem_bwd_finalize<<<(2 * C + threads - 1) / threads, threads, 0, st>>>(
      (const float*)partial, (float*)dab, nblk, C);
  return (int)cudaGetLastError();
}
