// Building blocks of the row kernels, csrc/rms_norm.cu and
// csrc/softmax.cu: the conversions between the three float types and
// fp32, 16-byte chunks unpacked to and packed from fp32, and the
// reduction of one value over the threads that own a row.
//
// A row is owned by `tpr` threads (a power of two, 32 to 1024), one or
// more rows a block; thread t of a row holds its 16-byte chunks t,
// t + tpr, t + 2 tpr, ..., so a warp's loads and stores are 512
// contiguous bytes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace rowops {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

// elements of T in one 16-byte chunk, and in one 32-bit word
template <typename T> constexpr int kVec = 16 / sizeof(T);
template <typename T> constexpr int kPerWord = 4 / sizeof(T);

// one 32-bit word's elements as fp32, in memory order (exact)
template <typename T> __device__ __forceinline__ void word_to_f(uint32_t w,
                                                                float* f);
template <> __device__ __forceinline__ void word_to_f<float>(uint32_t w,
                                                             float* f) {
  f[0] = __uint_as_float(w);
}
template <>
__device__ __forceinline__ void word_to_f<__nv_bfloat16>(uint32_t w,
                                                         float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}
template <> __device__ __forceinline__ void word_to_f<__half>(uint32_t w,
                                                              float* f) {
  __half2 h;
  memcpy(&h, &w, sizeof h);
  const float2 v = __half22float2(h);
  f[0] = v.x;
  f[1] = v.y;
}

// fp32 values rounded to nearest-even into one 32-bit word of T
template <typename T> __device__ __forceinline__ uint32_t f_to_word(
    const float* f);
template <> __device__ __forceinline__ uint32_t f_to_word<float>(
    const float* f) {
  return __float_as_uint(f[0]);
}
template <> __device__ __forceinline__ uint32_t f_to_word<__nv_bfloat16>(
    const float* f) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(f[0], f[1]);
  uint32_t w;
  memcpy(&w, &h, sizeof w);
  return w;
}
template <> __device__ __forceinline__ uint32_t f_to_word<__half>(
    const float* f) {
  const __half2 h = __floats2half2_rn(f[0], f[1]);
  uint32_t w;
  memcpy(&w, &h, sizeof w);
  return w;
}

// a 16-byte chunk's kVec<T> elements as fp32, and back
template <typename T>
__device__ __forceinline__ void chunk_to_f(const uint4& u, float* f) {
  constexpr int P = kPerWord<T>;
  word_to_f<T>(u.x, f);
  word_to_f<T>(u.y, f + P);
  word_to_f<T>(u.z, f + 2 * P);
  word_to_f<T>(u.w, f + 3 * P);
}
template <typename T>
__device__ __forceinline__ uint4 f_to_chunk(const float* f) {
  constexpr int P = kPerWord<T>;
  return make_uint4(f_to_word<T>(f), f_to_word<T>(f + P),
                    f_to_word<T>(f + 2 * P), f_to_word<T>(f + 3 * P));
}

// N values of T at p as fp32, read through the read-only path in
// 16-byte loads (8 bytes where N values are 8 bytes); p is aligned to
// the smaller of 16 and their size.
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* __restrict__ p, float* f) {
  constexpr int WORDS = N * (int)sizeof(T) / 4;
  static_assert(WORDS == 2 || WORDS % 4 == 0, "8 or 16k bytes");
  constexpr int P = kPerWord<T>;
  if constexpr (WORDS == 2) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    word_to_f<T>(u.x, f);
    word_to_f<T>(u.y, f + P);
  } else {
#pragma unroll
    for (int i = 0; i < WORDS / 4; ++i)
      chunk_to_f<T>(__ldg(reinterpret_cast<const uint4*>(p) + i),
                    f + i * kVec<T>);
  }
}

struct Sum {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return a + b;
  }
};
struct Max {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return fmaxf(a, b);
  }
};

// `op` of v over the tpr threads of a row, returned to each of them:
// a shuffle tree in each warp, then, for a row of several warps, one
// value a warp through `scratch` (a float for each warp of the block)
// and the same tree over those. Fixed order: every call on the same
// values gives the same bits. tpr is the same for the whole block, and
// every thread of the block calls this (it holds a __syncthreads when
// tpr > 32); a second reduction in the same kernel takes another
// `scratch`.
template <typename Op>
__device__ __forceinline__ float row_reduce(float v, float* scratch,
                                            int tpr, Op op,
                                            float identity) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = op(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (tpr > 32) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int warps = tpr / 32;
    if (lane == 0) scratch[warp] = v;
    __syncthreads();
    v = lane < warps ? scratch[warp / warps * warps + lane] : identity;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = op(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// threads a row: the fewest, a power of two and 32 at least, that hold
// `chunks` chunks at `per_thread` each (at most 1024: the callers
// refuse longer rows)
inline int threads_per_row(int chunks, int per_thread) {
  int t = 32;
  while (t * per_thread < chunks && t < 1024) t *= 2;
  return t;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace rowops
