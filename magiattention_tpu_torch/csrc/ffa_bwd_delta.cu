// FFA backward preprocessing: delta = rowsum(dO * O), for Hopper (sm_90a).
//
// Replaces: magiattention_tpu/kernels/ffa.py:_delta_kernel (wrapper
// _ffa_delta_pallas, pallas_call at ffa.py:1746).
//
// What it computes: for every q row i and q head h, delta[i, h] =
// sum_c out[i, h, c] * do[i, h, c] in float32. The dq and dk/dv kernels
// read it as dS = P * (dP - delta).
//
// Design. The TPU kernel works on a (head, q tile) block and writes its
// column broadcast over 128 lanes. Here the (row, head) pairs of the
// seq-major [sq, hq, dv] arrays are one flat list of rows of dv values, and
// ONE WARP owns one row: each lane reads 16-byte chunks of out and do,
// multiplies in float32, and a shuffle tree sums the lanes. Lane 0 writes
// the one float.
//
// What bounds it on this card: bytes. It reads out and do once (2 * dv *
// itemsize bytes per row) and writes 4 bytes per row; the 2 flops per
// element are nothing beside that. Rows are contiguous and neighbouring
// lanes read neighbouring 16-byte chunks, so every load is coalesced.
#include "common.cuh"

namespace {

using magi::Vec;

constexpr int NT = 256;
constexpr int WARPS = NT / 32;

template <typename T>
__global__ void __launch_bounds__(NT)
    ffa_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                         float* __restrict__ delta, long rows, int d) {
  const long row = (long)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  constexpr int VEC = Vec<T>::N;
  const T* o = out + row * d;
  const T* g = dout + row * d;
  float acc = 0.f;
  for (int c = lane * VEC; c < d; c += 32 * VEC)
    acc = Vec<T>::dot(magi::ldg16(o + c), magi::ldg16(g + c), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <typename T>
int launch(const void* out, const void* dout, float* delta, long rows, int d,
           void* stream) {
  if (d % Vec<T>::N) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const long blocks = (rows + WARPS - 1) / WARPS;
  ffa_bwd_delta_kernel<T><<<(unsigned)blocks, NT, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, rows, d);
  return (int)cudaGetLastError();
}

}  // namespace

// out and do are contiguous [rows, d] arrays of one dtype (rows = sq * hq),
// 16-byte aligned; delta is [rows] float32.
extern "C" int ffa_bwd_delta_f32(const void* out, const void* dout,
                                 float* delta, long rows, int d,
                                 void* stream) {
  return launch<float>(out, dout, delta, rows, d, stream);
}

extern "C" int ffa_bwd_delta_bf16(const void* out, const void* dout,
                                  float* delta, long rows, int d,
                                  void* stream) {
  return launch<__nv_bfloat16>(out, dout, delta, rows, d, stream);
}
