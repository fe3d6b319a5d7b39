// Image normalize: uint8 (B, H, W, 3) -> (x * scale[c] + offset[c]) in f32 or bf16.
//
// Replaces the TPU kernel in the JAX package's ops/preprocess.py
// `_pallas_normalize` (body `_kernel`), which views the image as
// (B*H, W*3) rows and applies per-channel scale = 1/(255*std) and
// offset = -mean/std.
//
// Bound on the H100: memory. Each element is 1 byte read and 2 (bf16) or 4
// (f32) bytes written for two flops, far below the card's ~295 flops/byte
// balance point. The design therefore makes one pass over the flat buffer:
// one thread per element in a grid-stride loop, neighbouring threads on
// neighbouring bytes so loads and stores coalesce, the channel taken as the
// flat index mod 3, the ragged tail masked by the loop bound. Vectorised
// 16-byte loads are left for a later change.
//
// Arithmetic: the product and the sum are rounded separately
// (__fmul_rn/__fadd_rn, never a contracted FMA), as the TPU kernel's
// `x * scale + offset` is, then rounded once to the output type.

#include <stdint.h>

#include "common.cuh"

namespace {

template <typename T>
__global__ void normalize_u8_kernel(const uint8_t* __restrict__ x, T* __restrict__ out,
                                    long long n, float s0, float s1, float s2,
                                    float o0, float o1, float o2) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int c = (int)(i % 3);
    const float s = c == 0 ? s0 : (c == 1 ? s1 : s2);
    const float o = c == 0 ? o0 : (c == 1 ? o1 : o2);
    out[i] = mmr::from_float<T>(__fadd_rn(__fmul_rn((float)x[i], s), o));
  }
}

}  // namespace

// out_bf16: 0 -> float32 output, 1 -> bfloat16 output.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mmr_normalize_u8(const void* x, void* out, long long n, int out_bf16,
                                float s0, float s1, float s2, float o0, float o1, float o2,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const int threads = 256;
  const unsigned int blocks = mmr::grid_for(n, threads);
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* xin = (const uint8_t*)x;
  if (out_bf16) {
    normalize_u8_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        xin, (__nv_bfloat16*)out, n, s0, s1, s2, o0, o1, o2);
  } else {
    normalize_u8_kernel<float><<<blocks, threads, 0, st>>>(
        xin, (float*)out, n, s0, s1, s2, o0, o1, o2);
  }
  return (int)cudaGetLastError();
}

// Message for an error code returned by any of the port's entry points.
extern "C" const char* mmr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
