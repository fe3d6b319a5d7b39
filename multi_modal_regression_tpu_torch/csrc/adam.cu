// Adam's update over every tensor of a param group in one launch.
//
// Replaces no TPU kernel: the JAX package leaves optax.adam to XLA, which
// fuses each leaf's elementwise chain into one pass. The port's
// train/presets.Adam ran the same chain as 16 torch._foreach passes and one
// cast a parameter, some 136 bytes of device memory traffic an element. This
// kernel is that chain in one pass (ops/adam.adam_update; the foreach passes
// stay as ops/adam.adam_update_plain).
//
// Bound on the H100: bytes. An element reads p, g, nu (float32) and mu
// (bfloat16 or float32) and writes p, mu and nu: 24 bytes with a bf16 mu,
// 28 with a float32 one, for 14 float32 operations (1 of them a division,
// 1 a square root), far below the card's ~20 float32 operations a byte.
// At the 548.0 M parameters of geodesic_bd_multires that is 13.15 GB, 3.93
// ms at 3.35 TB/s. So the design keeps the bytes at that count and enough of
// them in flight:
//   - Each tensor is cut into chunks of kChunk = 4096 elements, numbered
//     across the launch's tensors in order (`first`, 64-bit). A persistent
//     grid (as many blocks as the card holds at once, never more than the
//     chunks) walks them: block b takes chunks b, b + grid, b + 2 grid, ...
//     A 491.5 M-element bank and a 64-element BN vector are chunks alike,
//     so every block gets the same share of the bytes, give or take one
//     chunk (~0.1 MB).
//   - A thread takes 4 vectors of 4 elements of a chunk, 16-byte loads of
//     p, g and nu and 8- (bf16) or 16-byte loads of mu, all issued before
//     the first is used: up to 224 bytes in flight a thread. Neighbouring
//     threads take neighbouring vectors, so a warp's access is 512
//     contiguous bytes.
//   - A chunk whose four tensors are not all on a vector boundary (a view
//     into a larger tensor), and the last 1-3 elements of a tensor whose
//     size is no multiple of 4, go one element a thread.
//   - The tensors' pointers and sizes ride in the kernel's parameters
//     (`Table`, __grid_constant__, 48 bytes a tensor: 640 tensors in the
//     32,764 bytes that sm_90 takes from CUDA 12.1). The host packs the
//     table for each launch, or once where the launch is captured in a CUDA
//     graph (train/steps: the gradients keep their addresses from step to
//     step there); nothing is allocated and nothing waits for the host. A
//     group of more tensors takes one launch a table.
//   - The three scalars that change from step to step (-lr, 1 / bc1,
//     1 / bc2) are read from device memory (`Scalars::step`, 12 bytes the
//     host writes in stream order before the launch), so that a graph's
//     replay takes each step's rate and bias corrections.
// On an H100 80GB HBM3 at 700 W (112-114 registers, two blocks of 256 an
// SM): 4.61 ms at 548.0 M parameters, 85% of the bound; 0.73 ms at 85.95 M,
// 84%; the foreach passes take 29.8 and 5.5 ms.
//
// Arithmetic: the foreach passes' float32 operations in their order, each
// rounded on its own (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn, never a
// contracted FMA), so the kernel and adam_update_plain give the same bits.
// With the launch's scalars (host floats rounded to float32, as the foreach
// ops round a Python scalar; -lr, 1 / bc1 and 1 / bc2 rounded on the host too,
// then read from the device):
//     decayed = M(m * b1)                   b1 rounded to M on the host
//     mu      = g * (1 - b1) + decayed      the float32 first moment
//     nu      = nu * b2 + (g * g) * (1 - b2)
//     denom   = sqrt(nu * (1 / bc2)) + eps
//     p       = p + ((mu * (1 / bc1)) / denom) * (-lr)
//     m       = M(mu)                       rounded once, to nearest even
// where M is mu's dtype: for bf16, b1 * m is computed in float32 and rounded
// to bf16 as torch._foreach_mul does on a bf16 tensor, then widened. The two
// divisions by a scalar are products with its reciprocal, 1 / bc computed in
// double on the host and rounded to float32: that is what torch._foreach_div
// by a Python scalar computes on the card (torch 2.11; a true division would
// differ in about half the elements). The division by denom is a true one.

#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                                // elements a vector
constexpr int kUnroll = 4;                             // vectors a thread a chunk
constexpr long long kChunk = kThreads * kVec * kUnroll;  // 4096 elements

#if CUDART_VERSION < 12010
#error "the Adam kernel's table needs the 32,764 bytes of kernel parameters of CUDA 12.1"
#endif
constexpr int kMaxTensors = 640;  // 30,768 bytes of parameters

struct Scalars {
  float one_minus_b1, b1, b2, one_minus_b2, eps;
  const float* step;  // on the device: -lr, 1 / bc1, 1 / bc2
};

// the scalars of one step, as update() takes them
struct Step {
  float neg_lr, inv_bc1, inv_bc2;
};

struct Table {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  void* mu[kMaxTensors];
  float* nu[kMaxTensors];
  long long n[kMaxTensors];
  long long first[kMaxTensors + 1];  // first chunk of each tensor; first[tensors]: all
  int tensors;
};

template <typename T> struct alignas(kVec * sizeof(T)) Pack {
  T v[kVec];
};

// mu as stored (S): float, or a bfloat16's bits (so that a vector of four
// is a plain 8-byte load), widened to float and rounded back
__device__ __forceinline__ float widen(float m) { return m; }
__device__ __forceinline__ float widen(unsigned short m) {
  return __bfloat162float(__ushort_as_bfloat16(m));
}
__device__ __forceinline__ void narrow(float v, float& m) { m = v; }
__device__ __forceinline__ void narrow(float v, unsigned short& m) {
  m = __bfloat16_as_ushort(__float2bfloat16_rn(v));  // to nearest even, as torch's cast
}

template <typename S>
__device__ __forceinline__ void update(float& p, float g, S& m, float& v, const Scalars& s,
                                       const Step& t) {
  S decayed;
  narrow(__fmul_rn(widen(m), s.b1), decayed);
  const float mu = __fadd_rn(__fmul_rn(g, s.one_minus_b1), widen(decayed));
  v = __fadd_rn(__fmul_rn(v, s.b2), __fmul_rn(__fmul_rn(g, g), s.one_minus_b2));
  const float denom = __fadd_rn(__fsqrt_rn(__fmul_rn(v, t.inv_bc2)), s.eps);
  p = __fadd_rn(p, __fmul_rn(__fdiv_rn(__fmul_rn(mu, t.inv_bc1), denom), t.neg_lr));
  narrow(mu, m);
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
    adam_kernel(const __grid_constant__ Table t, const Scalars s) {
  const Step step{__ldg(s.step), __ldg(s.step + 1), __ldg(s.step + 2)};
  const long long chunks = t.first[t.tensors];
  int k = 0;  // the tensor of the block's chunk: chunks only grow
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    while (c >= t.first[k + 1]) ++k;
    const long long start = (c - t.first[k]) * kChunk;
    const int len = (int)min(kChunk, t.n[k] - start);
    float* p = t.p[k] + start;
    const float* g = t.g[k] + start;
    S* mu = static_cast<S*>(t.mu[k]) + start;
    float* nu = t.nu[k] + start;
    const bool vec = ((uintptr_t)p | (uintptr_t)g | (uintptr_t)nu) % 16 == 0 &&
                     (uintptr_t)mu % sizeof(Pack<S>) == 0;
    const int nvec = vec ? len / kVec : 0;
    Pack<float> pv[kUnroll], gv[kUnroll], vv[kUnroll];
    Pack<S> mv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (i < nvec) {
        pv[u] = reinterpret_cast<const Pack<float>*>(p)[i];
        gv[u] = reinterpret_cast<const Pack<float>*>(g)[i];
        vv[u] = reinterpret_cast<const Pack<float>*>(nu)[i];
        mv[u] = reinterpret_cast<const Pack<S>*>(mu)[i];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (i < nvec) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          update(pv[u].v[e], gv[u].v[e], mv[u].v[e], vv[u].v[e], s, step);
        }
        reinterpret_cast<Pack<float>*>(p)[i] = pv[u];
        reinterpret_cast<Pack<float>*>(nu)[i] = vv[u];
        reinterpret_cast<Pack<S>*>(mu)[i] = mv[u];
      }
    }
    for (int i = nvec * kVec + threadIdx.x; i < len; i += kThreads) {
      float pe = p[i], ve = nu[i];
      S me = mu[i];
      update(pe, g[i], me, ve, s, step);
      p[i] = pe;
      nu[i] = ve;
      mu[i] = me;
    }
  }
}

// blocks of adam_kernel<S> an SM holds at once, asked of the runtime once
template <typename S> cudaError_t blocks_per_sm(int* n) {
  static int held = 0;  // threads that race here write the same value
  if (held == 0) {
    int got = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&got, adam_kernel<S>, kThreads, 0);
    if (err != cudaSuccess) return err;
    held = got;
  }
  *n = held;
  return held > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <typename S>
cudaError_t launch(const long long* rows, int tensors, const Scalars& s, int sms,
                   cudaStream_t st, int* launched) {
  int per_sm = 0;
  const cudaError_t occ = blocks_per_sm<S>(&per_sm);
  if (occ != cudaSuccess) return occ;
  Table t;
  for (int lo = 0; lo < tensors; lo += kMaxTensors) {
    t.tensors = tensors - lo < kMaxTensors ? tensors - lo : kMaxTensors;
    long long chunks = 0;
    for (int i = 0; i < t.tensors; ++i) {
      const long long* r = rows + 5 * (long long)(lo + i);
      t.p[i] = (float*)(uintptr_t)r[0];
      t.g[i] = (const float*)(uintptr_t)r[1];
      t.mu[i] = (void*)(uintptr_t)r[2];
      t.nu[i] = (float*)(uintptr_t)r[3];
      t.n[i] = r[4];
      t.first[i] = chunks;
      chunks += (r[4] + kChunk - 1) / kChunk;
    }
    t.first[t.tensors] = chunks;
    if (chunks == 0) continue;
    const long long grid = (long long)sms * per_sm;
    adam_kernel<S><<<(unsigned)(chunks < grid ? chunks : grid), kThreads, 0, st>>>(t, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  return cudaSuccess;
}

}  // namespace

// One Adam step over `tensors` tensors: rows holds 5 int64 a tensor (p, g,
// mu, nu as device addresses, then its element count), each a dense,
// non-overlapping float32 tensor (mu bfloat16 where mu_bf16 is 1) of that
// many elements, the four laid out alike (ops/adam.fusable checks this).
// `step` is the device address of three float32: -lr, 1 / bc1, 1 / bc2,
// read by the kernels when they run.
// Launches kernels (one a 640 tensors holding elements) on `stream`, each
// of at most `sms` times the blocks an SM holds, and counts them in
// *launched. Returns cudaGetLastError() after the launches (0 on success),
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int mmr_adam(const long long* rows, int tensors, int mu_bf16, float one_minus_b1,
                        float b1, float b2, float one_minus_b2, float eps, const void* step,
                        int sms, int* launched, int device, void* stream) {
  *launched = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (tensors < 0 || sms < 1 || step == nullptr) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < tensors; ++i) {
    if (rows[5 * (long long)i + 4] < 0) return (int)cudaErrorInvalidValue;
  }
  const Scalars s{one_minus_b1, b1, b2, one_minus_b2, eps, (const float*)step};
  cudaStream_t st = (cudaStream_t)stream;
  err = mu_bf16 ? launch<unsigned short>(rows, tensors, s, sms, st, launched)
                : launch<float>(rows, tensors, s, sms, st, launched);
  return (int)err;
}
