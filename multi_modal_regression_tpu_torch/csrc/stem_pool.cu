// ResNet stem tail: p = maxpool3x3/2 pad 1(relu(y * a + b)), forward and backward.
//
// Forward: replaces the TPU kernel in the JAX package's ops/stem_pool.py
// `_stem_fwd` (body `_fwd_kernel`). Backward: replaces `_stem_bwd` (body
// `_bwd_kernel`). a, b are the folded BN affine (ops/fused_conv_bn.fold_bn,
// from running statistics in eval mode and from batch statistics in
// training), float32 per channel.
//
// Layout: y is (B, H, W, C) in memory, i.e. a (B, C, H, W) tensor in
// torch.channels_last, the format the trunk's conv1 writes; p and g are
// (B, H/2, W/2, C) in memory, dy like y. H and W are even.
//
// Bound on the H100: memory. The forward reads y and writes p (y + y/4
// elements); the backward reads g and y and writes dy (y/4 + 2 y). Both are
// stencils with a reduction, not products: no tensor-core work. What holds
// them back on the card is the rate at which an SM issues instructions: at
// the memory's rate it has a few tens of them to spend on a bf16 element of
// the backward (4.5 bytes), so the designs below count instructions as much
// as bytes.
//
// Design, both directions: a block takes a tile of th x tw pooled
// positions x cc channels (ops/stem_pool._stem_plan picks them) and walks
// tiles blockIdx.x, + gridDim.x, ... (grid y: channel tiles); the planned
// blocks (3 an SM forward, 2 backward) are all resident at once. Per tile:
//   halo   the y rows and columns the tile's windows touch are copied into
//          shared memory, all cc channels of a pixel contiguous, by 16-byte
//          cp.async (a "chunk" is one thread's 16 bytes of a pixel: 8 bf16
//          or 4 float32 channels; where C * sizeof(T) or a pointer is not a
//          multiple of 16, a chunk is one value, copied by a plain load).
//          Two slots: the next tile's copies are in flight while the block
//          works on this one. A thread keeps one chunk index (its channels)
//          for the whole kernel; its pixels advance by 32-bit offsets from
//          the tile's 64-bit base, without a division.
//   z      relu(T(T(y*a)+b)). Forward: each thread turns the chunks it
//          copied into z in place, once per halo element. Backward: the
//          argmax walk forms each tap's z as it reads it from the y slot
//          (~1.5 times per element): a stored z halo would be a third halo
//          buffer and cost more than it saves (measured on the H100).
//   windows forward: a thread takes an output column of the tile and walks
//          down it, the 3-column max of each halo row, then the 3-row max
//          (the bottom row's column max is the next output's top row); the
//          max is exact, so the separable order changes no bit. Backward:
//          the same walk takes each window's argmax tap into shared memory
//          (one byte a channel), the 3 taps of a row first, then the rows.
//   store  p, dy in 16-byte chunks.
// In bf16 the affine, the max and the argmax's compares and selects work on
// channel pairs (bf16x2 instructions); float32 and single values go one
// channel at a time in float.
//
// Rounding follows PyTorch's eager ops, so the forward is bit-identical to
// the plain version: a and b are first rounded to y's dtype (as the TPU
// kernel does), and the product and the sum are each rounded to it
// (mul.rn / add.rn, never a contracted FMA, or __fmul_rn / __fadd_rn). NaN
// is propagated, as torch.relu and max_pool2d propagate it (fmaxf would
// drop it). Padding: the forward's taps outside the image are zeros, which
// is exact (every tap is post-ReLU, >= 0, and no window is all padding);
// the backward's are -inf, so they never win a window (the affine is not
// applied to them: relu(b) need not be 0).
//
// Backward. Given g = dL/dp, y and a, b:
//   dy = route(g) * relu_mask * a      (in y's dtype, rounded once)
//   da = sum gz * y,  db = sum gz      (float32, over B, H, W)
// where gz = route(g) * relu_mask and route sends each pooled gradient to
// its window's argmax. The argmax follows torch's max_pool2d rule (row-major
// scan from -inf, strictly greater replaces, a NaN always replaces): taking
// each row's argmax by that rule and then the rows' by it again gives the
// same tap. The JAX kernel's factorized column-then-row rule differs from
// it only at positive bf16 ties across two window columns. A window whose
// winner has z <= 0 routes nothing (the winner's ReLU mask is 0; a NaN
// passes, as in torch's ReLU backward), so the mask is taken once a window.
// A tile owns input rows [2 oh0, 2 oh1) and columns likewise: row 2k lies
// in window k only, row 2k + 1 in windows k and k + 1, so the tile needs
// the windows oh0 .. oh1 (its own and the next tile's first, recomputed,
// not exchanged), hence the halo rows 2 oh0 - 1 .. 2 oh1 + 1, and the g of
// those windows. A thread gathers a 2 x 2 quad of owned elements under one
// pooled position from the <= 4 windows around it: each element's gz sums
// g in float32 in (oh, ow) ascending order, and dy = T(gz * a). No argmax
// buffer in device memory; y and g are read once from it, dy is written
// once.
//
// da, db: each thread sums its channels over its tiles; the block's
// threads of one chunk are summed in order into partial[blockIdx.x] (a
// (gridDim.x, 2, C) float32 buffer), and a second launch (stem_dab_kernel,
// a programmatic dependent of the first) sums the partials in a fixed
// order: no float atomics, the same bits on every run.

#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "common.cuh"
#include "sm90_tiles.cuh"

namespace {

using mmr::from_float;
using mmr::round_to;
using mmr::to_float;
using bf16 = __nv_bfloat16;

// Most threads a block, and the blocks an SM each direction is planned for
// (ops/stem_pool.py: _STEM_THREADS, _STEM_FWD_PER_SM, _STEM_BWD_PER_SM);
// __launch_bounds__ holds the registers to that, shared memory the planner.
constexpr int kThreads = 256;
constexpr int kFwdPerSM = 3;
constexpr int kBwdPerSM = 2;

// V channels of one pixel: 16 bytes (V = 16 / sizeof(T)) or one value
// (aligned to its size, at most 16 bytes).
template <typename T, int V>
struct alignas(sizeof(T) * V < 16 ? sizeof(T) * V : 16) Vec {
  T v[V];
};

// V argmax taps (0..8), one byte a channel.
template <int V> struct TapWord;
template <> struct TapWord<8> { using type = unsigned long long; };
template <> struct TapWord<4> { using type = unsigned int; };
template <> struct TapWord<2> { using type = unsigned short; };
template <> struct TapWord<1> { using type = unsigned char; };

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> lds(const T* p) {
  return *reinterpret_cast<const Vec<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void sts(T* p, const Vec<T, V>& v) {
  *reinterpret_cast<Vec<T, V>*>(p) = v;
}

__device__ __forceinline__ uint4 lds4(const void* p) { return *reinterpret_cast<const uint4*>(p); }
__device__ __forceinline__ void sts4(void* p, uint4 v) { *reinterpret_cast<uint4*>(p) = v; }

// One chunk global -> shared; outside the image (valid false) zeros. A
// 16-byte chunk goes by cp.async (`any` is a valid address for the skipped
// read), a narrower one by a plain load.
template <typename T, int V>
__device__ __forceinline__ void copy_in(T* dst, const T* src, const T* any, bool valid) {
  if constexpr (sizeof(T) * V == 16) {
    mmr::sm90::cp_async16(dst, valid ? src : any, valid);
  } else {
    Vec<T, V> c;
#pragma unroll
    for (int k = 0; k < V; ++k) c.v[k] = valid ? src[k] : from_float<T>(0.0f);
    sts<T, V>(dst, c);
  }
}

// bf16x2 arithmetic on pairs held in a u32 (low half: the lower channel),
// each op rounded once to nearest even, as torch's eager bf16 ops round
// (the float32 product of two bf16 values is exact, and so is the float32
// sum of two bf16 values wherever its bf16 rounding could differ); max.NaN
// propagates NaN.
__device__ __forceinline__ unsigned bmul2(unsigned x, unsigned y) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(x), "r"(y));
  return d;
}
__device__ __forceinline__ unsigned badd2(unsigned x, unsigned y) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(x), "r"(y));
  return d;
}
__device__ __forceinline__ unsigned bmax2(unsigned x, unsigned y) {
  unsigned d;
  asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(x), "r"(y));
  return d;
}
// 0xffff in each half where torch's max_pool2d scan takes v over m: v > m,
// or v is NaN
__device__ __forceinline__ unsigned btakes2(unsigned v, unsigned m) {
  unsigned gt, nan;
  asm("set.gt.u32.bf16x2 %0, %1, %2;" : "=r"(gt) : "r"(v), "r"(m));
  asm("set.neu.u32.bf16x2 %0, %1, %1;" : "=r"(nan) : "r"(v));
  return gt | nan;
}
__device__ __forceinline__ unsigned bsel(unsigned mask, unsigned a, unsigned b) {
  return (a & mask) | (b & ~mask);
}

// relu(T(T(y * a) + b)), a and b already rounded to T; NaN stays NaN.
template <typename T>
__device__ __forceinline__ float affine_relu(float v, float a, float b) {
  const float z = round_to<T>(__fadd_rn(round_to<T>(__fmul_rn(v, a)), b));
  return z < 0.0f ? 0.0f : z;
}

// A thread's a, b (rounded to T) for its V channels, and z of a chunk.
template <typename T, int V>
struct Affine {
  float a[V], b[V];
  __device__ __forceinline__ Affine(const float* ga, const float* gb, int c, bool active) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      a[k] = active ? round_to<T>(ga[c + k]) : 0.0f;
      b[k] = active ? round_to<T>(gb[c + k]) : 0.0f;
    }
  }
  __device__ __forceinline__ Vec<T, V> z(Vec<T, V> v) const {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      v.v[k] = from_float<T>(affine_relu<T>(to_float<T>(v.v[k]), a[k], b[k]));
    }
    return v;
  }
};

template <>
struct Affine<bf16, 8> {
  unsigned a[4], b[4];  // bf16 pairs
  __device__ __forceinline__ Affine(const float* ga, const float* gb, int c, bool active) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 pa = __floats2bfloat162_rn(active ? ga[c + 2 * k] : 0.0f,
                                                      active ? ga[c + 2 * k + 1] : 0.0f);
      const __nv_bfloat162 pb = __floats2bfloat162_rn(active ? gb[c + 2 * k] : 0.0f,
                                                      active ? gb[c + 2 * k + 1] : 0.0f);
      a[k] = *reinterpret_cast<const unsigned*>(&pa);
      b[k] = *reinterpret_cast<const unsigned*>(&pb);
    }
  }
  __device__ __forceinline__ uint4 z(uint4 v) const {
    v.x = bmax2(badd2(bmul2(v.x, a[0]), b[0]), 0u);
    v.y = bmax2(badd2(bmul2(v.y, a[1]), b[1]), 0u);
    v.z = bmax2(badd2(bmul2(v.z, a[2]), b[2]), 0u);
    v.w = bmax2(badd2(bmul2(v.w, a[3]), b[3]), 0u);
    return v;
  }
};

// z of the chunk at p, in place.
template <typename T, int V>
__device__ __forceinline__ void z_in_place(const Affine<T, V>& f, T* p) {
  sts<T, V>(p, f.z(lds<T, V>(p)));
}

__device__ __forceinline__ void z_in_place(const Affine<bf16, 8>& f, bf16* p) {
  sts4(p, f.z(lds4(p)));
}

// m = max(m, z); once NaN, stays NaN.
__device__ __forceinline__ void nanmax(float& m, float z) {
  if (m == m && !(z <= m)) m = z;
}

// torch's max_pool2d scan step: strictly greater replaces, NaN replaces.
__device__ __forceinline__ bool takes(float v, float m) { return v > m || v != v; }

// Max of the 3 chunks at p, p + cc, p + 2 cc (a row of a window, or the
// rows of one output): the float path, or bf16 pairs.
template <typename T, int V>
struct Max3 {
  float m[V];
  __device__ __forceinline__ void of(const T* p, int cc) {
    const Vec<T, V> u0 = lds<T, V>(p), u1 = lds<T, V>(p + cc), u2 = lds<T, V>(p + 2 * cc);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      m[k] = 0.0f;
      nanmax(m[k], to_float<T>(u0.v[k]));
      nanmax(m[k], to_float<T>(u1.v[k]));
      nanmax(m[k], to_float<T>(u2.v[k]));
    }
  }
  __device__ __forceinline__ void store(T* o, const Max3& mid, const Max3& bot) const {
    Vec<T, V> r;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float x = 0.0f;
      nanmax(x, m[k]);
      nanmax(x, mid.m[k]);
      nanmax(x, bot.m[k]);
      r.v[k] = from_float<T>(x);
    }
    sts<T, V>(o, r);
  }
};

template <>
struct Max3<bf16, 8> {
  uint4 m;
  __device__ __forceinline__ void of(const bf16* p, int cc) {
    const uint4 u0 = lds4(p), u1 = lds4(p + cc), u2 = lds4(p + 2 * cc);
    m.x = bmax2(bmax2(u0.x, u1.x), u2.x);
    m.y = bmax2(bmax2(u0.y, u1.y), u2.y);
    m.z = bmax2(bmax2(u0.z, u1.z), u2.z);
    m.w = bmax2(bmax2(u0.w, u1.w), u2.w);
  }
  __device__ __forceinline__ void store(bf16* o, const Max3& mid, const Max3& bot) const {
    uint4 r;
    r.x = bmax2(bmax2(m.x, mid.m.x), bot.m.x);
    r.y = bmax2(bmax2(m.y, mid.m.y), bot.m.y);
    r.z = bmax2(bmax2(m.z, mid.m.z), bot.m.z);
    r.w = bmax2(bmax2(m.w, mid.m.w), bot.m.w);
    *reinterpret_cast<uint4*>(o) = r;
  }
};

// The argmax of the 3 taps of a window row (max m, tap column i), by
// torch's scan from -inf; then, combined over the window's 3 rows, the
// window's tap (3 row + column) as V bytes, or kNoTap where the winner's z
// is <= 0 (its ReLU mask is 0, so the window routes nothing). The float
// path, or bf16 pairs (indices as 16-bit halves).
constexpr unsigned kNoTap = 0xff;

template <typename T, int V>
struct Arg3 {
  float m[V];
  int i[V];
  // the taps' z from the raw y chunks at p, p + cc, p + 2 cc; with kEdge,
  // -inf for each tap whose bit in `in` (bit k: tap k inside the image) is 0
  template <bool kEdge>
  __device__ __forceinline__ void of(const T* p, int cc, const Affine<T, V>& f, unsigned in) {
    const Vec<T, V> u0 = f.z(lds<T, V>(p)), u1 = f.z(lds<T, V>(p + cc)),
                    u2 = f.z(lds<T, V>(p + 2 * cc));
    const float pad = -__int_as_float(0x7f800000);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float v0 = to_float<T>(u0.v[k]), v1 = to_float<T>(u1.v[k]), v2 = to_float<T>(u2.v[k]);
      if (kEdge) {
        v0 = in & 1u ? v0 : pad;
        v1 = in & 2u ? v1 : pad;
        v2 = in & 4u ? v2 : pad;
      }
      m[k] = v0;  // the first step from -inf takes the tap, or stays -inf
      i[k] = 0;
      if (takes(v1, m[k])) { m[k] = v1; i[k] = 1; }
      if (takes(v2, m[k])) { m[k] = v2; i[k] = 2; }
    }
  }
  __device__ __forceinline__ typename TapWord<V>::type taps(const Arg3& mid,
                                                           const Arg3& bot) const {
    using Word = typename TapWord<V>::type;
    Word word = 0;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float x = m[k];
      int best = i[k];
      if (takes(mid.m[k], x)) { x = mid.m[k]; best = 3 + mid.i[k]; }
      if (takes(bot.m[k], x)) { x = bot.m[k]; best = 6 + bot.i[k]; }
      if (!takes(x, 0.0f)) best = kNoTap;  // the winner's z <= 0: masked
      word |= (Word)best << (8 * k);
    }
    return word;
  }
};

template <>
struct Arg3<bf16, 8> {
  uint4 m, i;
  __device__ __forceinline__ static void step(unsigned v, unsigned& m, unsigned& i,
                                              unsigned tap) {
    const unsigned t = btakes2(v, m);
    m = bsel(t, v, m);
    i = bsel(t, tap, i);
  }
  template <bool kEdge>
  __device__ __forceinline__ void of(const bf16* p, int cc, const Affine<bf16, 8>& f,
                                     unsigned in) {
    const uint4 pad = make_uint4(0xff80ff80u, 0xff80ff80u, 0xff80ff80u, 0xff80ff80u);  // -inf
    uint4 u0 = f.z(lds4(p)), u1 = f.z(lds4(p + cc)), u2 = f.z(lds4(p + 2 * cc));
    if (kEdge) {
      u0 = in & 1u ? u0 : pad;
      u1 = in & 2u ? u1 : pad;
      u2 = in & 4u ? u2 : pad;
    }
    m = u0;
    i = make_uint4(0u, 0u, 0u, 0u);
    step(u1.x, m.x, i.x, 0x00010001u);
    step(u1.y, m.y, i.y, 0x00010001u);
    step(u1.z, m.z, i.z, 0x00010001u);
    step(u1.w, m.w, i.w, 0x00010001u);
    step(u2.x, m.x, i.x, 0x00020002u);
    step(u2.y, m.y, i.y, 0x00020002u);
    step(u2.z, m.z, i.z, 0x00020002u);
    step(u2.w, m.w, i.w, 0x00020002u);
  }
  __device__ __forceinline__ static unsigned pair(unsigned m0, unsigned i0, unsigned m1,
                                                  unsigned i1, unsigned m2, unsigned i2) {
    unsigned t = btakes2(m1, m0);
    m0 = bsel(t, m1, m0);
    i0 = bsel(t, i1 + 0x00030003u, i0);
    t = btakes2(m2, m0);
    m0 = bsel(t, m2, m0);
    i0 = bsel(t, i2 + 0x00060006u, i0);
    return bsel(btakes2(m0, 0u), i0, kNoTap * 0x00010001u);  // the winner's z <= 0: masked
  }
  __device__ __forceinline__ unsigned long long taps(const Arg3& mid, const Arg3& bot) const {
    const unsigned x = pair(m.x, i.x, mid.m.x, mid.i.x, bot.m.x, bot.i.x);
    const unsigned y = pair(m.y, i.y, mid.m.y, mid.i.y, bot.m.y, bot.i.y);
    const unsigned z = pair(m.z, i.z, mid.m.z, mid.i.z, bot.m.z, bot.i.z);
    const unsigned w = pair(m.w, i.w, mid.m.w, mid.i.w, bot.m.w, bot.i.w);
    // bytes 0 and 2 of each pair: the channels' taps in order
    return (unsigned long long)__byte_perm(z, w, 0x6420) << 32 | __byte_perm(x, y, 0x6420);
  }
};

struct Tile {
  int n, oh0, ow0;  // image, first pooled row, first pooled column
};

__device__ __forceinline__ Tile tile_at(int t, int tr, int tc, int th, int tw) {
  const int per = tr * tc;
  Tile r;
  r.n = t / per;
  const int rest = t - r.n * per;
  const int i = rest / tc;
  r.oh0 = i * th;
  r.ow0 = (rest - i * tc) * tw;
  return r;
}

__host__ __device__ inline int align16(int n) { return (n + 15) / 16 * 16; }

// The forward's shared memory: two slots of the z halo, (2 th + 1) x
// (2 tw + 1) pixels (the next tile's copies land in one while the block
// works in the other).
inline int fwd_smem(int th, int tw, int cc, int itemsize) {
  return 2 * align16((2 * th + 1) * (2 * tw + 1) * cc * itemsize);
}

// The backward's: two slots of the y halo, (2 th + 3) x (2 tw + 3) pixels,
// and of the g of the (th + 1) x (tw + 1) windows; the windows' argmax
// bytes; each chunk's Affine (at most 8 bytes a channel) and the float32 a
// (loaded where a phase needs them, so they hold no registers across the
// walk); at the end the block's da, db sums (threads x V x 2 floats) reuse
// it.
inline int bwd_smem(int th, int tw, int cc, int itemsize, int threads, int vec) {
  const int halo = align16((2 * th + 3) * (2 * tw + 3) * cc * itemsize);
  const int win = (th + 1) * (tw + 1) * cc;
  const int layout = 2 * halo + 2 * align16(win * itemsize) + align16(win) + align16(8 * cc) +
                     align16(4 * cc);
  const int red = 8 * vec * threads;
  return layout > red ? layout : red;
}

// A thread's pixels p = pl, pl + ps, ... of a halo `width` pixels wide,
// taken from rows `pitch` pixels apart: (row, column) and the element
// offset (row * pitch + column) * C from the halo's first pixel, advanced
// without a division or a 64-bit product. in(): inside a height x pitch
// image whose pixel (0, 0) is halo pixel (-r0, -c0).
struct HaloWalk {
  int hr, hc, off, dr, dc, doff, wrap, width;
  __device__ __forceinline__ HaloWalk(int pl, int ps, int w, int pitch, int C) : width(w) {
    hr = pl / w;
    hc = pl - hr * w;
    dr = ps / w;
    dc = ps - dr * w;
    off = (hr * pitch + hc) * C;
    doff = (dr * pitch + dc) * C;
    wrap = (pitch - w) * C;
  }
  __device__ __forceinline__ bool in(int r0, int c0, int height, int pitch) const {
    return (unsigned)(hr + r0) < (unsigned)height && (unsigned)(hc + c0) < (unsigned)pitch;
  }
  __device__ __forceinline__ void next() {
    hr += dr;
    hc += dc;
    off += doff;
    if (hc >= width) {
      hc -= width;
      ++hr;
      off += wrap;
    }
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kFwdPerSM)
stem_fwd_kernel(const T* __restrict__ y, const float* __restrict__ a,
                const float* __restrict__ b, T* __restrict__ out, int B, int H, int W, int C,
                int cc, int th, int tw) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int HC = 2 * tw + 1, npix = (2 * th + 1) * HC;
  T* const slot0 = reinterpret_cast<T*>(smem);
  const int slot = align16(npix * cc * (int)sizeof(T)) / (int)sizeof(T);  // elements
  const int OH = H / 2, OW = W / 2;
  const int tr = (OH + th - 1) / th, tc = (OW + tw - 1) / tw;
  const int ntiles = B * tr * tc;  // < 2**31 (the wrapper checks)
  const int nch = cc / V, ps = blockDim.x / nch;  // chunks a pixel, threads a chunk
  const int ch = threadIdx.x % nch, pl = threadIdx.x / nch;
  const int c = blockIdx.y * cc + ch * V;
  const bool active = pl < ps && c < C;
  const Affine<T, V> aff(a, b, c, active);
  // the y halo of tile t into a slot, this thread's chunks
  auto copy = [&](int t, T* zs) {
    const Tile tl = tile_at(t, tr, tc, th, tw);
    const int h0 = 2 * tl.oh0 - 1, w0 = 2 * tl.ow0 - 1;
    // the halo's first pixel (it may lie outside the image: only chunks
    // inside are read)
    const T* src = y + (((long long)tl.n * H + h0) * W + w0) * C + c;
    T* dst = zs + pl * cc + ch * V;
    HaloWalk hw(pl, ps, HC, W, C);
    for (int p = pl; p < npix; p += ps, hw.next(), dst += ps * cc) {
      copy_in<T, V>(dst, src + hw.off, y, hw.in(h0, w0, H, W));
    }
  };
  // the walk down an output column: rg groups of `rows` outputs
  const int rg = max(1, min(th, ps / tw)), rows = (th + rg - 1) / rg;
  int t = blockIdx.x;
  if (active && t < ntiles) copy(t, slot0);
  mmr::sm90::cp_async_commit();
  for (int k = 0; t < ntiles; t += gridDim.x, ++k) {
    T* zs = slot0 + (k & 1) * slot;
    if (active && t + gridDim.x < ntiles) copy(t + gridDim.x, slot0 + ((k + 1) & 1) * slot);
    mmr::sm90::cp_async_commit();
    mmr::sm90::cp_async_wait<1>();  // this tile's copies (the next tile's fly on)
    const Tile tl = tile_at(t, tr, tc, th, tw);
    if (active) {  // z of the chunks this thread copied; padding stays 0
      const int h0 = 2 * tl.oh0 - 1, w0 = 2 * tl.ow0 - 1;
      T* at = zs + pl * cc + ch * V;
      HaloWalk hw(pl, ps, HC, W, C);
      for (int p = pl; p < npix; p += ps, hw.next(), at += ps * cc) {
        if (hw.in(h0, w0, H, W)) z_in_place(aff, at);
      }
    }
    __syncthreads();
    if (active) {
      for (int it = pl; it < tw * rg; it += ps) {
        const int q = it % tw, r0 = (it / tw) * rows;
        const int r1 = min(min(th, r0 + rows), OH - tl.oh0);
        if (tl.ow0 + q >= OW || r0 >= r1) continue;
        const T* col = zs + 2 * q * cc + ch * V;  // halo column 2q, row 0
        const int row = HC * cc;
        Max3<T, V> top, mid, bot;
        top.of(col + 2 * r0 * row, cc);
        T* o = out + (((long long)tl.n * OH + tl.oh0 + r0) * OW + tl.ow0 + q) * C + c;
        for (int r = r0; r < r1; ++r, o += (long long)OW * C) {
          mid.of(col + (2 * r + 1) * row, cc);
          bot.of(col + (2 * r + 2) * row, cc);
          top.store(o, mid, bot);
          top = bot;
        }
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this slot
  }
  mmr::sm90::cp_async_wait<0>();
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kBwdPerSM)
stem_bwd_kernel(const T* __restrict__ g, const T* __restrict__ y, const float* __restrict__ a,
                const float* __restrict__ b, T* __restrict__ dy, float* __restrict__ partial,
                int B, int H, int W, int C, int cc, int th, int tw) {
  // the gather takes a 16-byte chunk in two halves (fewer live registers)
  constexpr int kHalves = sizeof(T) * V == 16 ? 2 : 1, VH = V / kHalves;
  using Word = typename TapWord<V>::type;
  using HalfWord = typename TapWord<VH>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int HC = 2 * tw + 3, HR = 2 * th + 3, npix = HR * HC;
  const int WC = tw + 1, nwin = (th + 1) * WC;
  const int halo = align16(npix * cc * (int)sizeof(T));
  const int gbytes = align16(nwin * cc * (int)sizeof(T));
  // y slots at 0 and halo, g slots at 2 halo and 2 halo + gbytes, then the
  // argmax bytes
  T* const ys0 = reinterpret_cast<T*>(smem);
  T* const gs0 = reinterpret_cast<T*>(smem + 2 * halo);
  unsigned char* const as = smem + 2 * halo + 2 * gbytes;
  Affine<T, V>* const saff =
      reinterpret_cast<Affine<T, V>*>(as + align16(nwin * cc));  // one a chunk
  float* const saf = reinterpret_cast<float*>(as + align16(nwin * cc) + align16(8 * cc));
  const int yslot = halo / (int)sizeof(T), gslot = gbytes / (int)sizeof(T);  // elements
  const int OH = H / 2, OW = W / 2;
  const int tr = (OH + th - 1) / th, tc = (OW + tw - 1) / tw;
  const int ntiles = B * tr * tc;  // < 2**31 (the wrapper checks)
  const int nch = cc / V, ps = blockDim.x / nch;
  const int ch = threadIdx.x % nch, pl = threadIdx.x / nch;
  const int c0 = blockIdx.y * cc, c = c0 + ch * V;
  const bool active = pl < ps && c < C;
  if (pl == 0) {  // ordered before their use by the walk's first barrier
    saff[ch] = Affine<T, V>(a, b, c, active);
#pragma unroll
    for (int k = 0; k < V; ++k) saf[ch * V + k] = active ? a[c + k] : 0.0f;
  }
  float da[V], db[V];
#pragma unroll
  for (int k = 0; k < V; ++k) da[k] = db[k] = 0.0f;
  // the y halo and the windows' g of tile t into a slot, this thread's chunks
  auto copy = [&](int t, int s) {
    const Tile tl = tile_at(t, tr, tc, th, tw);
    const int h0 = 2 * tl.oh0 - 1, w0 = 2 * tl.ow0 - 1;
    // the halo's first pixel (it may lie outside the image: only chunks
    // inside are read)
    const T* src = y + (((long long)tl.n * H + h0) * W + w0) * C + c;
    T* dst = ys0 + s * yslot + pl * cc + ch * V;
    HaloWalk hw(pl, ps, HC, W, C);
    for (int p = pl; p < npix; p += ps, hw.next(), dst += ps * cc) {
      copy_in<T, V>(dst, src + hw.off, y, hw.in(h0, w0, H, W));
    }
    const T* gsrc = g + (((long long)tl.n * OH + tl.oh0) * OW + tl.ow0) * C + c;
    T* gdst = gs0 + s * gslot + pl * cc + ch * V;
    HaloWalk ww(pl, ps, WC, OW, C);
    for (int p = pl; p < nwin; p += ps, ww.next(), gdst += ps * cc) {
      copy_in<T, V>(gdst, gsrc + ww.off, g, ww.in(tl.oh0, tl.ow0, OH, OW));
    }
  };
  // the argmax walk down a window column: rg groups of `rows` windows
  const int rg = max(1, min(th + 1, ps / WC)), rows = (th + 1 + rg - 1) / rg;
  int t = blockIdx.x;
  if (active && t < ntiles) copy(t, 0);
  mmr::sm90::cp_async_commit();
  for (int k = 0; t < ntiles; t += gridDim.x, ++k) {
    const int s = k & 1;
    if (active && t + gridDim.x < ntiles) copy(t + gridDim.x, s ^ 1);
    mmr::sm90::cp_async_commit();
    mmr::sm90::cp_async_wait<1>();  // this tile's copies (the next tile's fly on)
    __syncthreads();                // and every thread's
    const Tile tl = tile_at(t, tr, tc, th, tw);
    const int h0 = 2 * tl.oh0 - 1, w0 = 2 * tl.ow0 - 1;
    const T* yq = ys0 + s * yslot;
    // each window's argmax tap: z of its taps from the y slot, row by row,
    // then the rows; taps outside the image are -inf (a tile on the image's
    // edge masks them, the others have none)
    auto argmax = [&](auto edge) {
      constexpr bool kEdge = decltype(edge)::value;
      const Affine<T, V> aff = saff[ch];
      for (int it = pl; it < WC * rg; it += ps) {
        const int wc = it % WC, wr0 = (it / WC) * rows;
        const int wr1 = min(min(th + 1, wr0 + rows), OH - tl.oh0);
        if (tl.ow0 + wc >= OW || wr0 >= wr1) continue;
        const T* col = yq + 2 * wc * cc + ch * V;  // halo column 2 wc, row 0
        const int row = HC * cc;
        unsigned cols = 0;  // bit k: halo column 2 wc + k inside the image
#pragma unroll
        for (int k2 = 0; k2 < 3; ++k2) cols |= (unsigned)(w0 + 2 * wc + k2) < (unsigned)W ? 1u << k2 : 0u;
        auto in = [&](int hr) { return (unsigned)(h0 + hr) < (unsigned)H ? cols : 0u; };
        Arg3<T, V> top, mid, bot;
        top.template of<kEdge>(col + 2 * wr0 * row, cc, aff, in(2 * wr0));
        for (int wr = wr0; wr < wr1; ++wr) {
          mid.template of<kEdge>(col + (2 * wr + 1) * row, cc, aff, in(2 * wr + 1));
          bot.template of<kEdge>(col + (2 * wr + 2) * row, cc, aff, in(2 * wr + 2));
          const Word word = top.taps(mid, bot);
          *reinterpret_cast<Word*>(as + (wr * WC + wc) * cc + ch * V) = word;
          top = bot;
        }
      }
    };
    if (active) {
      const bool edge = h0 < 0 || w0 < 0 || h0 + HR > H || w0 + HC > W;  // the same in the block
      if (edge) {
        argmax(std::true_type{});
      } else {
        argmax(std::false_type{});
      }
    }
    __syncthreads();
    if (active) {  // dy of the owned elements, a 2 x 2 quad under each pooled position
      const T* gq = gs0 + s * gslot;
      const Vec<float, V> af = *reinterpret_cast<const Vec<float, V>*>(saf + ch * V);
      T* dyt = dy + (((long long)tl.n * H + 2 * tl.oh0) * W + 2 * tl.ow0) * C + c;
      for (int qd = pl; qd < th * tw; qd += ps) {
        const int i = qd / tw, j = qd - i * tw;
        if (tl.oh0 + i >= OH || tl.ow0 + j >= OW) continue;
        const bool right = tl.ow0 + j + 1 < OW, down = tl.oh0 + i + 1 < OH;
        // windows (i, j), (i, j + 1), (i + 1, j), (i + 1, j + 1): taps and g
        const int w00 = (i * WC + j) * cc + ch * V, w01 = w00 + cc, w10 = w00 + WC * cc,
                  w11 = w10 + cc;
        // the quad's pixels: halo rows 2i + 1, 2i + 2, columns 2j + 1, 2j + 2
        const int p00 = ((2 * i + 1) * HC + 2 * j + 1) * cc + ch * V, p01 = p00 + cc,
                  p10 = p00 + HC * cc, p11 = p10 + cc;
        auto taps_at = [&](int at, bool exists) -> HalfWord {
          return exists ? *reinterpret_cast<const HalfWord*>(as + at)
                        : (HalfWord)~(HalfWord)0;  // no tap matches
        };
        Vec<T, V> d00, d01, d10, d11;
#pragma unroll
        for (int hh = 0; hh < kHalves; ++hh) {
          const int o = hh * VH;
          const HalfWord t00 = taps_at(w00 + o, true), t01 = taps_at(w01 + o, right),
                         t10 = taps_at(w10 + o, down), t11 = taps_at(w11 + o, right && down);
          const Vec<T, VH> g00 = lds<T, VH>(gq + w00 + o), g01 = lds<T, VH>(gq + w01 + o),
                           g10 = lds<T, VH>(gq + w10 + o), g11 = lds<T, VH>(gq + w11 + o);
          const Vec<T, VH> y00 = lds<T, VH>(yq + p00 + o), y01 = lds<T, VH>(yq + p01 + o),
                           y10 = lds<T, VH>(yq + p10 + o), y11 = lds<T, VH>(yq + p11 + o);
#pragma unroll
          for (int k2 = 0; k2 < VH; ++k2) {
            const int k = o + k2;
            const int s00 = (int)((t00 >> (8 * k2)) & 0xff), s01 = (int)((t01 >> (8 * k2)) & 0xff),
                      s10 = (int)((t10 >> (8 * k2)) & 0xff), s11 = (int)((t11 >> (8 * k2)) & 0xff);
            const float ga = to_float<T>(g00.v[k2]), gb = to_float<T>(g01.v[k2]),
                        gc = to_float<T>(g10.v[k2]), gd = to_float<T>(g11.v[k2]);
            // g routed to each pixel (masked windows route nothing), its
            // windows in (oh, ow) ascending order
            float e00 = 0.0f, e01 = 0.0f, e10 = 0.0f, e11 = 0.0f;
            if (s00 == 4) e00 += ga;
            if (s00 == 5) e01 += ga;
            if (s01 == 3) e01 += gb;
            if (s00 == 7) e10 += ga;
            if (s10 == 1) e10 += gc;
            if (s00 == 8) e11 += ga;
            if (s01 == 6) e11 += gb;
            if (s10 == 2) e11 += gc;
            if (s11 == 0) e11 += gd;
            d00.v[k] = from_float<T>(e00 * af.v[k]);
            d01.v[k] = from_float<T>(e01 * af.v[k]);
            d10.v[k] = from_float<T>(e10 * af.v[k]);
            d11.v[k] = from_float<T>(e11 * af.v[k]);
            da[k] += e00 * to_float<T>(y00.v[k2]);
            da[k] += e01 * to_float<T>(y01.v[k2]);
            da[k] += e10 * to_float<T>(y10.v[k2]);
            da[k] += e11 * to_float<T>(y11.v[k2]);
            db[k] += e00;
            db[k] += e01;
            db[k] += e10;
            db[k] += e11;
          }
        }
        T* o = dyt + (2 * i * W + 2 * j) * C;
        sts<T, V>(o, d00);
        sts<T, V>(o + C, d01);
        sts<T, V>(o + (long long)W * C, d10);
        sts<T, V>(o + (long long)W * C + C, d11);
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this slot
  }
  mmr::sm90::cp_async_wait<0>();
  asm volatile("griddepcontrol.launch_dependents;");  // the da, db sum may start launching
  // the block's da, db: its threads of one chunk in order (pl ascending)
  float* red = reinterpret_cast<float*>(smem);  // (ps, 2, cc)
  if (active) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      red[(pl * 2 + 0) * cc + ch * V + k] = da[k];
      red[(pl * 2 + 1) * cc + ch * V + k] = db[k];
    }
  }
  __syncthreads();
  const int ncc = min(cc, C - c0);
  for (int i = threadIdx.x; i < 2 * ncc; i += blockDim.x) {
    const int which = i / ncc, col = i - which * ncc;
    float sum = 0.0f;
    for (int j = 0; j < ps; ++j) sum += red[(j * 2 + which) * cc + col];
    partial[((long long)blockIdx.x * 2 + which) * C + c0 + col] = sum;
  }
}

// dab[i] = sum over j of partial[j * L + i], i < L = 2 C: 32 interleaved
// subsets of the P partials each summed in order, then the 32 sums in
// order; the order depends on P alone, so every run gives the same bits.
// It is launched as a programmatic dependent of the backward kernel (its
// launch overlaps that kernel's last blocks) and waits for the kernel's
// completion before it reads a partial.
__global__ void __launch_bounds__(1024)
stem_dab_kernel(const float* __restrict__ partial, float* __restrict__ dab, int P, int L) {
  __shared__ float s[32][33];
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int i = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.0f;
  if (i < L) {
#pragma unroll 4
    for (int j = threadIdx.y; j < P; j += 32) acc += __ldcg(partial + (long long)j * L + i);
  }
  s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && i < L) {
    float t = 0.0f;
#pragma unroll
    for (int r = 0; r < 32; ++r) t += s[r][threadIdx.x];
    dab[i] = t;
  }
}

// The launch shape from ops/stem_pool._stem_plan, checked against what the
// kernels assume: a vec of 16 bytes' worth needs C, cc and the pointers to
// hold whole 16-byte chunks; the threads are whole groups of cc / vec.
bool plan_ok(int C, int vec, int wide, int cc, int th, int tw, int threads, int blocks,
             std::initializer_list<const void*> ptrs) {
  if (vec != 1 && vec != wide) return false;
  if (cc < vec || cc % vec || th < 1 || tw < 1 || blocks < 1) return false;
  if (vec > 1) {
    if (C % vec) return false;
    for (const void* p : ptrs) {
      if ((uintptr_t)p % 16) return false;
    }
  }
  const int nch = cc / vec;
  return threads >= nch && threads <= kThreads && threads % nch == 0;
}

template <typename K>
cudaError_t launch_setup(K* kernel, int smem) {
  return smem > 48 * 1024 ? mmr::sm90::allow_smem(kernel, smem) : cudaSuccess;
}

template <typename T, int V>
cudaError_t stem_fwd(const void* y, const void* a, const void* b, void* out, int B, int H,
                     int W, int C, int cc, int th, int tw, int threads, int blocks,
                     cudaStream_t st) {
  auto* kernel = stem_fwd_kernel<T, V>;
  const int smem = fwd_smem(th, tw, cc, (int)sizeof(T));
  cudaError_t err = launch_setup(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks, (C + cc - 1) / cc);
  kernel<<<grid, threads, smem, st>>>((const T*)y, (const float*)a, (const float*)b, (T*)out,
                                      B, H, W, C, cc, th, tw);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t stem_bwd(const void* g, const void* y, const void* a, const void* b, void* dy,
                     void* partial, void* dab, int B, int H, int W, int C, int cc, int th,
                     int tw, int threads, int blocks, cudaStream_t st) {
  auto* kernel = stem_bwd_kernel<T, V>;
  const int smem = bwd_smem(th, tw, cc, (int)sizeof(T), threads, V);
  cudaError_t err = launch_setup(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks, (C + cc - 1) / cc);
  kernel<<<grid, threads, smem, st>>>((const T*)g, (const T*)y, (const float*)a,
                                      (const float*)b, (T*)dy, (float*)partial, B, H, W, C,
                                      cc, th, tw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((2 * C + 31) / 32);
  cfg.blockDim = dim3(32, 32);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, stem_dab_kernel, (const float*)partial, (float*)dab, blocks,
                            2 * C);
}

}  // namespace

// y (B, H, W, C) and out (B, H/2, W/2, C): float32 (is_bf16 0) or bfloat16
// (1); a, b float32 (C,). vec (channels a thread moves at once: 16 bytes'
// worth, or 1), cc (channels a block), th x tw (pooled positions a tile),
// threads and blocks (a block walks tiles blocks apart) from
// ops/stem_pool._stem_plan. Returns cudaGetLastError() after the launch (0
// on success), cudaErrorInvalidValue for a plan the kernel cannot take.
extern "C" int mmr_stem_fwd(const void* y, const void* a, const void* b, void* out, int B,
                            int H, int W, int C, int is_bf16, int vec, int cc, int th, int tw,
                            int threads, int blocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((long long)B * (H / 2) * (W / 2) * C <= 0) return 0;
  if (!plan_ok(C, vec, is_bf16 ? 8 : 4, cc, th, tw, threads, blocks, {y, out})) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (is_bf16) {
    err = vec == 1 ? stem_fwd<bf16, 1>(y, a, b, out, B, H, W, C, cc, th, tw, threads, blocks, st)
                   : stem_fwd<bf16, 8>(y, a, b, out, B, H, W, C, cc, th, tw, threads, blocks, st);
  } else {
    err = vec == 1 ? stem_fwd<float, 1>(y, a, b, out, B, H, W, C, cc, th, tw, threads, blocks, st)
                   : stem_fwd<float, 4>(y, a, b, out, B, H, W, C, cc, th, tw, threads, blocks, st);
  }
  return (int)err;
}

// g (B, H/2, W/2, C) and y, dy (B, H, W, C) in y's dtype (is_bf16 as
// above); a, b float32 (C,); partial float32 (blocks, 2, C) scratch; dab
// float32 (2, C) gets (da, db). The launch shape as for mmr_stem_fwd. Two
// launches: the kernel, then the fixed-order sum of the partials. Returns
// the first CUDA error (0 on success).
extern "C" int mmr_stem_bwd(const void* g, const void* y, const void* a, const void* b,
                            void* dy, void* partial, void* dab, int B, int H, int W, int C,
                            int is_bf16, int vec, int cc, int th, int tw, int threads,
                            int blocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((long long)B * (H / 2) * (W / 2) * C <= 0) return 0;
  if (!plan_ok(C, vec, is_bf16 ? 8 : 4, cc, th, tw, threads, blocks, {g, y, dy})) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (is_bf16) {
    err = vec == 1
              ? stem_bwd<bf16, 1>(g, y, a, b, dy, partial, dab, B, H, W, C, cc, th, tw, threads,
                                  blocks, st)
              : stem_bwd<bf16, 8>(g, y, a, b, dy, partial, dab, B, H, W, C, cc, th, tw, threads,
                                  blocks, st);
  } else {
    err = vec == 1
              ? stem_bwd<float, 1>(g, y, a, b, dy, partial, dab, B, H, W, C, cc, th, tw,
                                   threads, blocks, st)
              : stem_bwd<float, 4>(g, y, a, b, dy, partial, dab, B, H, W, C, cc, th, tw,
                                   threads, blocks, st);
  }
  return (int)err;
}
