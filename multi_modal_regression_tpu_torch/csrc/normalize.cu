// Image normalize: uint8 (B, H, W, 3) -> (x * scale[c] + offset[c]) in f32 or bf16.
//
// Replaces the TPU kernel in the JAX package's ops/preprocess.py
// `_pallas_normalize` (body `_kernel`), which views the image as
// (B*H, W*3) rows and applies per-channel scale = 1/(255*std) and
// offset = -mean/std.
//
// Bound on the H100: bytes. Each value is 1 byte read and 2 (bf16) or 4
// (f32) bytes written for two flops: a (64, 224, 224, 3) batch moves
// 28,901,376 bytes into bf16 (0.0086 ms at 3.35 TB/s) and 48,168,960 into
// f32, far below the card's ~20 float32 flops a byte. So the kernel moves
// its bytes in 16-byte accesses and keeps the instructions a value few
// enough that the memory, not the issue, sets the pace:
//   - A thread takes a 48-byte group (48 is the least common multiple of a
//     16-byte access and the 3-channel period) with three 16-byte loads,
//     all in flight before the first value is used, and writes it as six
//     (bf16, pairs packed by __floats2bfloat162_rn) or twelve (f32) 16-byte
//     chunks. A group starts at a multiple of 3 values, so each byte's
//     channel is fixed by its place in the group: no modulo at all.
//   - A warp's 32 groups are 3 or 6 KB of contiguous output. Written straight
//     from the threads, each store instruction would put 16 bytes into each
//     of 32 sectors 96 or 192 bytes apart, half a 32-byte sector each, and the
//     H100 takes such partial writes several times slower than whole ones
//     (slower than the first design's one value a thread). So a warp stages its
//     chunks in shared memory (a lane-turned layout, free of bank conflicts)
//     and stores them in order, 512 contiguous bytes an instruction.
//   - One group a thread and 256 threads a block: every block's loads are
//     in flight at once, 12 KB a block, no grid-stride loop. Offsets inside
//     a block's span are 32-bit; the block's base and the item index are
//     64-bit, so a batch of any size that fits the card takes one launch.
//   - The groups need x on a 16-byte boundary (the output is allocated
//     fresh, so it is). ops/preprocess._normalize_plan takes the groups
//     where x is aligned, and one pixel a thread (three single values, the
//     channels in order) for the n mod 48 values after them, or for all of
//     them where x is not aligned (a view such as x[1:] of an odd-sized
//     batch).
//
// Arithmetic: the product and the sum are rounded separately
// (__fmul_rn/__fadd_rn, never a contracted FMA), as the TPU kernel's
// `x * scale + offset` is, then rounded once to the output type (to nearest
// even). ops/preprocess.normalize_affine_plain does the same in two eager
// ops and gives the same bits.

#include <stdint.h>
#include <string.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 48;  // bytes in, values out, a thread

// 16-byte chunks of a thread's 48 outputs: 6 in bf16, 12 in f32
template <typename T> __host__ __device__ constexpr int out_chunks() {
  return kGroup * (int)sizeof(T) / 16;
}

__device__ __forceinline__ float affine(float x, float s, float o) {
  return __fadd_rn(__fmul_rn(x, s), o);
}

__device__ __forceinline__ void pack(const float (&f)[kGroup], uint4 (&c)[12]) {
#pragma unroll
  for (int q = 0; q < 12; ++q) {
    c[q] = make_uint4(__float_as_uint(f[4 * q]), __float_as_uint(f[4 * q + 1]),
                      __float_as_uint(f[4 * q + 2]), __float_as_uint(f[4 * q + 3]));
  }
}

__device__ __forceinline__ void pack(const float (&f)[kGroup], uint4 (&c)[6]) {
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    unsigned u[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(f[8 * q + 2 * h], f[8 * q + 2 * h + 1]);
      memcpy(&u[h], &p, sizeof(unsigned));  // .x, the lower address, in the low half
    }
    c[q] = make_uint4(u[0], u[1], u[2], u[3]);
  }
}

// where a warp's chunk j (thread j / Q's chunk j % Q) sits in its staging
// buffer: the low three bits turned by the thread's lane, so that the eight
// lanes of a 16-byte shared-memory access hit eight different bank groups
// both when a thread writes its chunks and when the warp reads them in order
template <int Q> __device__ __forceinline__ int staged(int j) { return j ^ ((j / Q) & 7); }

// items 0 .. groups - 1: 48-byte groups from byte 0; items groups ..
// groups + pixels - 1: pixels of 3 values from byte 48 * groups
template <typename T>
__global__ void __launch_bounds__(kThreads)
    normalize_u8_kernel(const uint8_t* __restrict__ x, T* __restrict__ out,
                        uint64_t groups, uint64_t pixels, float s0, float s1, float s2,
                        float o0, float o1, float o2) {
  constexpr int Q = out_chunks<T>();
  // a warp's outputs, 3 KB (bf16) or 6 KB (f32), staged so that each of its
  // store instructions writes 512 contiguous bytes: whole 32-byte sectors
  __shared__ uint4 stage[kThreads / 32][32 * Q];
  const float s[3] = {s0, s1, s2};
  const float o[3] = {o0, o1, o2};
  const int lane = threadIdx.x % 32;
  const uint64_t i = (uint64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < groups) {
    const size_t base = (size_t)blockIdx.x * (kThreads * kGroup);
    const unsigned off = threadIdx.x * kGroup;  // 32-bit inside the block's span
    const uint4* src = reinterpret_cast<const uint4*>(x + base + off);
    const uint4 in[3] = {src[0], src[1], src[2]};
    const unsigned w[12] = {in[0].x, in[0].y, in[0].z, in[0].w, in[1].x, in[1].y,
                            in[1].z, in[1].w, in[2].x, in[2].y, in[2].z, in[2].w};
    float f[kGroup];
#pragma unroll
    for (int e = 0; e < kGroup; ++e) {
      f[e] = affine((float)((w[e / 4] >> (8 * (e % 4))) & 0xffu), s[e % 3], o[e % 3]);
    }
    uint4 c[Q];
    pack(f, c);
    if (i - lane + 32 <= groups) {  // the whole warp takes groups
      uint4* buf = stage[threadIdx.x / 32];
#pragma unroll
      for (int q = 0; q < Q; ++q) buf[staged<Q>(lane * Q + q)] = c[q];
      __syncwarp();
      uint4* dst = reinterpret_cast<uint4*>(out + base + (off - lane * kGroup));
#pragma unroll
      for (int q = 0; q < Q; ++q) dst[q * 32 + lane] = buf[staged<Q>(q * 32 + lane)];
    } else {  // the one warp where the groups end: each thread its own chunks
      uint4* dst = reinterpret_cast<uint4*>(out + base + off);
#pragma unroll
      for (int q = 0; q < Q; ++q) dst[q] = c[q];
    }
  } else if (i - groups < pixels) {
    const uint64_t e0 = groups * kGroup + (i - groups) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      out[e0 + c] = mmr::from_float<T>(affine((float)x[e0 + c], s[c], o[c]));
    }
  }
}

}  // namespace

// x (n,) uint8 as groups * 48 + pixels * 3 values, out (n,) float32
// (out_bf16 0) or bfloat16 (1), on a 16-byte boundary; x on one too where
// groups > 0. blocks of 256 threads cover groups + pixels items
// (ops/preprocess._normalize_plan). Returns cudaGetLastError() after the
// launch (0 on success), cudaErrorInvalidValue for a shape the kernel does
// not take.
extern "C" int mmr_normalize_u8(const void* x, void* out, long long groups, long long pixels,
                                int blocks, int out_bf16, float s0, float s1, float s2,
                                float o0, float o1, float o2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long items = groups + pixels;
  if (items <= 0) return 0;
  if (groups < 0 || pixels < 0 || blocks < 1 || (long long)blocks * kThreads < items ||
      (groups > 0 && ((uintptr_t)x % 16 != 0 || (uintptr_t)out % 16 != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* xin = (const uint8_t*)x;
  const uint64_t g = (uint64_t)groups, p = (uint64_t)pixels;
  if (out_bf16) {
    normalize_u8_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        xin, (__nv_bfloat16*)out, g, p, s0, s1, s2, o0, o1, o2);
  } else {
    normalize_u8_kernel<float><<<blocks, kThreads, 0, st>>>(
        xin, (float*)out, g, p, s0, s1, s2, o0, o1, o2);
  }
  return (int)cudaGetLastError();
}

// Message for an error code returned by any of the port's entry points.
extern "C" const char* mmr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
