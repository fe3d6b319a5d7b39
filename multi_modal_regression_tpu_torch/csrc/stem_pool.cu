// ResNet stem tail, forward: p = maxpool3x3/2 pad 1(relu(y * a + b)) in one pass.
//
// Replaces the TPU kernel in the JAX package's ops/stem_pool.py
// `_stem_fwd` (body `_fwd_kernel`). a, b are the folded eval-mode BN affine
// (ops/fused_conv_bn.fold_bn), float32 per channel.
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
