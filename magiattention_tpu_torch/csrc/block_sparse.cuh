// What csrc/block_sparse_fwd.cu (B13) and csrc/block_sparse_bwd.cu (B14)
// share: the place of one CTA, the row maps and the gathered loads.
//
// A chunk table row (kv head h, q block b) names C chunks of ds keys each;
// its n_keys = C * ds keys, in table order, are the keys every query row of
// the block attends (a chunk named twice counts twice, as in the gathered
// reference). The block's r = block_size_q * g query rows are tile rows
// R = qi * g + gi: q position b * block_size_q + qi, q head h * g + gi (the
// GQA group of kv head h), so q, dO, out, dq, lse and delta are read and
// written straight in their (S, h, d) / (S, h) layouts, with no transposed
// copy. A CTA takes 64 of the r rows (blockIdx.z) and walks the table row
// 64 keys at a time. At d = 256 every kernel also splits the columns it
// writes in two 128-column halves, one a CTA (BSP_DV).
#pragma once

#include "common.cuh"

namespace {

constexpr int BSP_ROWS = 64;  // query rows of one CTA
constexpr int BSP_KEYS = 64;  // gathered keys per step
constexpr int BSP_NT = 256;

// The (S, h) row of tile row R of (kv head h, q block b), -1 past the r
// rows of the block.
struct RowMap {
  int b, h, bq, g, hq, r_total;

  __device__ __forceinline__ long operator()(int R) const {
    if (R >= r_total) return -1;
    return (long)(b * bq + R / g) * hq + h * g + R % g;
  }
};

// The key row of each of step k0's 64 key slots (flat position f = k0 + j
// of the table row's keys), -1 past n_keys. Threads 0..63 write krow; the
// caller synchronizes.
__device__ __forceinline__ void step_keys(int* krow, const int* tbl_row,
                                          int k0, int n_keys, int ds) {
  if (threadIdx.x < BSP_KEYS) {
    const int f = k0 + threadIdx.x;
    krow[threadIdx.x] = f < n_keys ? tbl_row[f / ds] * ds + f % ds : -1;
  }
}

// 64 rows of D values into dst (row stride D + 4, float32): tile row r
// from src + off(r) * LD (rows LD values wide: a D-column chunk of a wider
// row where LD > D), zeros where off(r) < 0. All threads take part.
template <typename T, int D, int LD = D, typename Off>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          const Off& off) {
  constexpr int VEC = magi::Vec<T>::N;
  constexpr int CPR = D / VEC;  // 16-byte chunks per row
  constexpr int ITER = 64 * CPR / BSP_NT;
  constexpr int DS = D + 4;
  uint4 raw[ITER];
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    const int i = threadIdx.x + it * BSP_NT;
    const int r = i / CPR, c = (i % CPR) * VEC;
    const long o = off(r);
    raw[it] = o >= 0 ? magi::ldg16(src + o * LD + c)
                     : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    const int i = threadIdx.x + it * BSP_NT;
    const int r = i / CPR, c = (i % CPR) * VEC;
    magi::Vec<T>::to_f32(raw[it], dst + r * DS + c, 1.f);
  }
}

// The output columns one CTA writes (a 128-column half at D = 256), and
// the halves of a row.
template <int D>
constexpr int BSP_DV = D > 128 ? 128 : D;
template <int D>
constexpr int BSP_NCH = D / BSP_DV<D>;

// The (S, hk) row of each gathered key slot of kv head h.
struct KeyMap {
  const int* krow;
  int h, hk;

  __device__ __forceinline__ long operator()(int r) const {
    return krow[r] < 0 ? -1 : (long)krow[r] * hk + h;
  }
};

}  // namespace
