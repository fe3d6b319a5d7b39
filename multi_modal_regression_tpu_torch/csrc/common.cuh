// Helpers shared by the port's kernels: float <-> storage-type conversion.
//
// Every kernel computes in float32 and rounds to the storage type exactly
// where PyTorch's eager ops round (after each elementwise op), so a kernel
// and its plain PyTorch version give the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mmr {

template <typename T> __device__ __forceinline__ float to_float(T v);
template <> __device__ __forceinline__ float to_float<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as torch's .to(bfloat16)
}

// Round a float32 value to T's precision, keeping it as a float.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_float<T>(from_float<T>(v));
}

}  // namespace mmr
