// Pose-bin assignment: out[i] = argmin_k (|c_k|^2 - 2 y_i . c_k), int32.
//
// Replaces the TPU kernel in the JAX package's ops/assign.py
// `_pallas_assign` (body `_kernel`), which streams 1024-row tiles of y
// through fast memory with the centers and their squared norms resident and
// fuses the distance with the argmin, so that no (N, K) matrix is ever
// written to device memory. |y_i|^2 is constant per row and is dropped.
//
// Bound on the H100: float32 arithmetic, not memory. A row is D floats in
// and one int32 out (16 bytes at D = 3) for K (2 D + 2) operations (1,600 at
// K = 200), ~100 operations per byte against the card's ~20 float32
// operations per byte. The design therefore keeps all operands next to the
// arithmetic: the K centers and their K squared norms sit in shared memory
// (3.2 KB at K = 200, D = 3), each thread holds one row's D values in
// registers and walks the K centers with a running (minimum, index), and
// every shared-memory read is a broadcast (all lanes of a warp read the same
// center). Nothing carries over between blocks. Register tiling over several
// rows per thread, to amortise the shared-memory reads, is left for a later
// change.
//
// Arithmetic, chosen so that the kernel and its plain PyTorch version
// (ops/assign.assign_bins_plain) give the same bits: products and sums are
// rounded one by one (__fmul_rn/__fadd_rn/__fsub_rn, never a contracted
// FMA), the cross term and the squared norms are summed over d in index
// order, and the distance is c2 - 2 * cross. Ties keep the lowest index
// (strict <). A NaN distance wins its row and the first NaN keeps it, as
// torch.argmin and jnp.argmin have it.

#include <stdint.h>

#include "common.cuh"

namespace {

template <int D>
__global__ void assign_kernel(const float* __restrict__ y, const float* __restrict__ centers,
                              int32_t* __restrict__ out, long long n, int k) {
  extern __shared__ float smem[];
  float* sc = smem;           // (K, D) centers, row-major as given
  float* sc2 = smem + k * D;  // (K,) squared norms
  for (int i = threadIdx.x; i < k * D; i += blockDim.x) sc[i] = centers[i];
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    float s = __fmul_rn(sc[j * D], sc[j * D]);
#pragma unroll
    for (int d = 1; d < D; ++d) s = __fadd_rn(s, __fmul_rn(sc[j * D + d], sc[j * D + d]));
    sc2[j] = s;
  }
  __syncthreads();

  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float v[D];
#pragma unroll
  for (int d = 0; d < D; ++d) v[d] = y[row * D + d];

  float best = 0.0f;
  int best_j = 0;
  for (int j = 0; j < k; ++j) {
    float cross = __fmul_rn(v[0], sc[j * D]);
#pragma unroll
    for (int d = 1; d < D; ++d) cross = __fadd_rn(cross, __fmul_rn(v[d], sc[j * D + d]));
    const float dist = __fsub_rn(sc2[j], __fmul_rn(2.0f, cross));
    // the first center starts the minimum; later a smaller distance takes
    // it, and so does a NaN unless a NaN holds it already
    if (j == 0 || dist < best || (dist != dist && best == best)) {
      best = dist;
      best_j = j;
    }
  }
  out[row] = best_j;
}

}  // namespace

// y (n, d) float32, centers (k, d) float32, out (n,) int32, all contiguous;
// d in 1..4, k >= 1, (k * (d + 1)) floats within the 48 KB of static-limit
// shared memory. Returns cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int mmr_assign(const void* y, const void* centers, void* out, long long n, int d,
                          int k, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const size_t smem = (size_t)k * (d + 1) * sizeof(float);
  if (k < 1 || d < 1 || d > 4 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* yy = (const float*)y;
  const float* cc = (const float*)centers;
  int32_t* oo = (int32_t*)out;
  const unsigned int g = (unsigned int)blocks;
  switch (d) {
    case 1: assign_kernel<1><<<g, threads, smem, st>>>(yy, cc, oo, n, k); break;
    case 2: assign_kernel<2><<<g, threads, smem, st>>>(yy, cc, oo, n, k); break;
    case 3: assign_kernel<3><<<g, threads, smem, st>>>(yy, cc, oo, n, k); break;
    default: assign_kernel<4><<<g, threads, smem, st>>>(yy, cc, oo, n, k); break;
  }
  return (int)cudaGetLastError();
}
