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
};

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Opt a kernel into more than 48 KB of dynamic shared memory, once.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) *done = true;
  return e;
}

}  // namespace magi

extern "C" const char* magi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
