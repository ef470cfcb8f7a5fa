// Helpers shared by the port's hand-written Hopper kernels.
//
// Each kernel source includes this header and is compiled on its own into a
// shared library with a plain C interface (kernels/_build.py), loaded with
// ctypes. Tiles live in shared memory as float32 whatever the input type, so
// one kernel body serves float32 and bfloat16 inputs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace magi {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// One 16-byte global load (the caller guarantees 16-byte alignment).
template <typename T>
__device__ __forceinline__ uint4 ldg16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// 16 raw bytes of T -> float32 values at dst (16-byte aligned), times mul.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;  // elements per 16 bytes
  __device__ __forceinline__ static void to_f32(const uint4& raw, float* dst,
                                                float mul) {
    const float4 f = *reinterpret_cast<const float4*>(&raw);
    *reinterpret_cast<float4*>(dst) =
        make_float4(f.x * mul, f.y * mul, f.z * mul, f.w * mul);
  }
  // acc + the float32 dot product of two 16-byte chunks
  __device__ __forceinline__ static float dot(const uint4& a, const uint4& b,
                                              float acc) {
    const float4 x = *reinterpret_cast<const float4*>(&a);
    const float4 y = *reinterpret_cast<const float4*>(&b);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    return fmaf(x.w, y.w, acc);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void to_f32(const uint4& raw, float* dst,
                                                float mul) {
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a0 = __bfloat1622float2(b[0]);
    const float2 a1 = __bfloat1622float2(b[1]);
    const float2 a2 = __bfloat1622float2(b[2]);
    const float2 a3 = __bfloat1622float2(b[3]);
    *reinterpret_cast<float4*>(dst) =
        make_float4(a0.x * mul, a0.y * mul, a1.x * mul, a1.y * mul);
    *reinterpret_cast<float4*>(dst + 4) =
        make_float4(a2.x * mul, a2.y * mul, a3.x * mul, a3.y * mul);
  }
  __device__ __forceinline__ static float dot(const uint4& a, const uint4& b,
                                              float acc) {
    const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 u = __bfloat1622float2(x[i]);
      const float2 v = __bfloat1622float2(y[i]);
      acc = fmaf(u.x, v.x, acc);
      acc = fmaf(u.y, v.y, acc);
    }
    return acc;
  }
};

// int8 codes (quantized KV pages): mul is the code's dequantization scale.
template <>
struct Vec<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void to_f32(const uint4& raw, float* dst,
                                                float mul) {
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 16; i += 4)
      *reinterpret_cast<float4*>(dst + i) =
          make_float4((float)b[i] * mul, (float)b[i + 1] * mul,
                      (float)b[i + 2] * mul, (float)b[i + 3] * mul);
  }
};

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// One work item of the host plan (kernels/ffa_plan.py): its slice
// rectangle [qs, qe) x [ks, ke), band lo <= j - i <= hi and IS_FULL flag,
// read from its meta row (META_DIM int32 columns) once per item.
constexpr int META_DIM = 15;

struct Item {
  int qs, qe, ks, ke, lo, hi;
  bool full;

  __device__ __forceinline__ explicit Item(const int* mt)
      : qs(mt[0]), qe(mt[1]), ks(mt[2]), ke(mt[3]), lo(mt[4]), hi(mt[5]),
        full(mt[8] != 0) {}

  // a dummy item (an uncovered tile's placeholder) has an empty rectangle
  __device__ __forceinline__ bool empty() const {
    return qe <= qs || ke <= ks;
  }

  // is (row gi, col gj) inside the rectangle and the band?
  __device__ __forceinline__ bool live(int gi, int gj) const {
    const int dl = gj - gi;
    return gi >= qs && gi < qe && gj >= ks && gj < ke && dl >= lo && dl <= hi;
  }
};

// 64 rows of D values, row r at src + r * row_stride, into dst (row stride
// D + 4, so the 16-byte reads of 8 neighbouring threads hit distinct banks)
// as float32; rows at or past n_valid are zero. All NT threads take part.
template <typename T, int D, int NT>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long row_stride, int n_valid) {
  constexpr int VEC = Vec<T>::N;
  constexpr int CPR = D / VEC;  // 16-byte chunks per row
  constexpr int ITER = 64 * CPR / NT;
  constexpr int DS = D + 4;
  uint4 raw[ITER];
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    const int i = threadIdx.x + it * NT;
    const int r = i / CPR, c = (i % CPR) * VEC;
    raw[it] = r < n_valid ? ldg16(src + (long)r * row_stride + c)
                          : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    const int i = threadIdx.x + it * NT;
    const int r = i / CPR, c = (i % CPR) * VEC;
    Vec<T>::to_f32(raw[it], dst + r * DS + c, 1.f);
  }
}

// The dynamic shared memory one CTA may opt into on an H100 (sm_90): 227
// KB. A tile instance is compiled only where its CTA fits.
constexpr size_t SMEM_LIMIT = 232448;

// The (head dim, q tile rows, k tile rows) instances of the FFA kernels
// (kernels/ffa.py, utils/mem_budget.py): X(D, BQ, BK) for each; a
// library's entry compiles those whose CTA fits SMEM_LIMIT (and whose
// body takes the pair) and returns cudaErrorInvalidValue for the rest. At
// D = 256 the bf16 forward compiles 64 x 64 and 128 x 64, the bf16 dq and
// k-major backward 64 x 64, the float32 forward 64 x 64 and 64 x 128.
#define MAGI_FFA_TILES(X)                                               \
  X(64, 64, 64) X(64, 128, 64) X(64, 64, 128) X(64, 128, 128)           \
  X(128, 64, 64) X(128, 128, 64) X(128, 64, 128) X(128, 128, 128)       \
  X(256, 64, 64) X(256, 128, 64) X(256, 64, 128) X(256, 128, 128)

// The devices on which a kernel's dynamic shared-memory limit is raised:
// cudaFuncSetAttribute sets it for the current device only, and one
// process may launch a kernel on several (the head-sharded decode step).
constexpr int SMEM_DEVICES = 64;
struct SmemAllowed {
  bool on[SMEM_DEVICES] = {};
};

// Opt a kernel into more than 48 KB of dynamic shared memory, once per
// device. Static: kernels of one signature in two libraries must each
// reach their own library's CUDA runtime.
template <typename Kernel>
static inline cudaError_t allow_smem(Kernel kernel, size_t bytes, SmemAllowed* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < SMEM_DEVICES && done->on[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess && dev < SMEM_DEVICES) done->on[dev] = true;
  return e;
}

}  // namespace magi

extern "C" const char* magi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
