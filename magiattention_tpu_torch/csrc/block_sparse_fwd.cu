// NSA selected-branch forward over a chunk table, for Hopper (sm_90a).
//
// Replaces: magiattention_tpu/kernels/block_sparse.py:_bsp_fwd_kernel
// (wrapper _bsp_fwd_pallas, pallas_call at block_sparse.py:186).
//
// What it computes: for every kv head h, q block b and query row of the
// block (its g = hq / hk heads folded into the rows, csrc/block_sparse.cuh),
// softmax attention over the n_keys = C * ds keys that the chunk table row
// (h, b) names, a chunk named twice counting twice: out = P V in q's dtype,
// lse = log(sum exp(s)) in natural log, float32, (S, hq). A row with no key
// gives out 0 and lse -inf (valid tables have none).
//
// Design. The TPU kernel's grid (hk, n_qb, C) walks the chunks of one row
// as sequential grid steps, DMAs one ds-row chunk per step through the
// scalar-prefetched table and carries m/l/acc in VMEM scratch; q is
// pre-scaled on the host in q's dtype. Here ONE CTA owns 64 query rows of
// one (kv head, q block) and loops over the row's keys itself, 64 at a
// time, each step's key rows gathered from k (S, hk, d) through the table;
// any ds works (a step may span several chunks or part of one), key slots
// past n_keys are masked, the softmax scale is applied to the float32
// scores (exp2 domain), m/l/acc stay in registers, out and lse are written
// once, and nothing is atomic. Two bodies:
// - bfloat16: csrc/block_sparse_tc.cuh on the tensor cores (wgmma, one
//   warpgroup; K and V gathered by cp.async into swizzled tiles,
//   double-buffered; P in registers as the A operand of O += P V). Bound:
//   4 * d flops per (query row, key slot) pair at 989 TFLOP/s (H100 SXM);
//   82,944 bytes of shared memory at d = 128, two CTAs per SM.
// - float32: the CUDA-core body below, the FFA forward's online-softmax
//   step (csrc/ffa_fwd.cuh: scores, softmax_update, pv_accumulate; the V
//   tile replaces the K tile) on gathered float32 tiles, for the 1e-5 gate.
//   Bound: the same flops on the CUDA cores (67 TFLOP/s); 88 KB of shared
//   memory at d = 128 (the Q tile, one K-or-V tile, the 64 x 80 P tile, 64
//   key rows), one CTA per SM there (registers), two at d = 64.
// At d = 256 both bodies split out's columns: a CTA takes one 128-column
// half (grid z = row tile * 2 + half) with the width-128 register plan and
// recomputes S over the full width (Q and K tiles 256 wide, the V tile its
// half): 129 KB (bf16) and 150 KB (float32) of shared memory, one CTA per
// SM.
#include <type_traits>

#include "ffa_fwd.cuh"
#include "block_sparse.cuh"
#include "block_sparse_tc.cuh"

namespace {

template <int D>
struct BspFwdSmem {
  static constexpr int DS = D + 4;
  static constexpr int PSTR = BSP_KEYS + 16;
  static constexpr size_t bytes =
      sizeof(float) * (BSP_ROWS * DS + BSP_KEYS * DS + BSP_ROWS * PSTR) +
      sizeof(int) * BSP_KEYS;
};

// At d = 128 the float32 body needs more than the 128 registers a thread
// that two CTAs an SM leave (ptxas spilled there): one CTA an SM.
template <typename T, int D>
__global__ void __launch_bounds__(BSP_NT, D >= 128 ? 1 : 2)
    block_sparse_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ tbl, T* __restrict__ out,
                            float* __restrict__ lse, int hq, int hk, int bq,
                            int n_qb, int C, int ds, float scale) {
  static_assert(BSP_ROWS == BQ && BSP_KEYS == BK && BSP_NT == NT,
                "the FFA forward helpers' tile shape");
  constexpr int W = BSP_DV<D>;  // out columns of this CTA
  constexpr int NCH = BSP_NCH<D>;
  constexpr int DS = D + 4;
  constexpr int CG = RowState<W>::CG;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* KVs = Qs + BSP_ROWS * DS;  // the K tile, then the V tile (half)
  float* Ps = KVs + BSP_KEYS * DS;
  int* krow = reinterpret_cast<int*>(Ps + BSP_ROWS * BspFwdSmem<D>::PSTR);

  const int b = blockIdx.x, h = blockIdx.y;
  const int row0 = (int)(blockIdx.z / NCH) * BSP_ROWS;
  const int ch = NCH > 1 ? (int)(blockIdx.z % NCH) : 0;  // the column half
  const int g = hq / hk;
  const RowMap rows{b, h, bq, g, hq, bq * g};
  const int n_keys = C * ds;
  const int* tbl_row = tbl + ((long)h * n_qb + b) * C;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  load_rows<T, D>(Qs, q, [&](int r) { return rows(row0 + r); });

  RowState<W> st;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    st.m[i] = -INFINITY;
    st.l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * CG; ++c) st.acc[i][c] = 0.f;
  }
  const float qk_scale = scale * LOG2E;
  const KeyMap keys{krow, h, hk};

  for (int k0 = 0; k0 < n_keys; k0 += BSP_KEYS) {
    __syncthreads();  // the previous step's P V is done with KVs, Ps, krow
    step_keys(krow, tbl_row, k0, n_keys, ds);
    __syncthreads();
    load_rows<T, D>(KVs, k, keys);
    __syncthreads();

    // key slots past n_keys are masked; every query row is live
    const int mt[magi::META_DIM] = {
        0, BSP_ROWS, 0, n_keys, -(1 << 30), 1 << 30, 0, 0,
        k0 + BSP_KEYS <= n_keys, 0, 0, 0, 0, 0, 0};
    const magi::Item item(mt);
    float s[4][4];
    scores<D>(s, Qs, KVs, tx, ty, qk_scale, 0.f, item, 0, k0);
    softmax_update<W>(s, st, Ps, tx, ty);
    __syncthreads();  // P is visible, S is done with the K tile
    load_rows<T, W, D>(KVs, v + ch * W, keys);
    __syncthreads();
    pv_accumulate<W>(st, Ps, KVs, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long row = rows(row0 + ty + 16 * i);
    if (row < 0) continue;
    const bool empty = st.l[i] == 0.f;
    T* o = out + row * D + ch * W;
#pragma unroll
    for (int cg = 0; cg < CG; ++cg)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        magi::store_out(o + cg * 64 + tx * 4 + e,
                        empty ? 0.f : st.acc[i][cg * 4 + e] / st.l[i]);
    if (tx == 0 && ch == 0)
      lse[row] = empty ? -INFINITY : (st.m[i] + log2f(st.l[i])) * LN2;
  }
}

template <typename T, int D>
int bsp_launch(const void* q, const void* k, const void* v, const int* tbl,
               void* out, float* lse, int hq, int hk, int bq, int n_qb, int C,
               int ds, float scale, void* stream) {
  static bool smem_ok = false;
  constexpr bool TC = !std::is_same<T, float>::value;
  const size_t smem = TC ? bsp_tc::FwdSmem<D>::bytes : BspFwdSmem<D>::bytes;
  const int r_total = bq * (hq / hk);
  const dim3 grid(n_qb, hk,
                  (r_total + BSP_ROWS - 1) / BSP_ROWS * BSP_NCH<D>);
  if constexpr (TC) {
    cudaError_t e = magi::allow_smem(bsp_tc::bsp_fwd_tc_kernel<D>, smem, &smem_ok);
    if (e != cudaSuccess) return (int)e;
    bsp_tc::bsp_fwd_tc_kernel<D><<<grid, 128, smem, (cudaStream_t)stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), tbl,
        static_cast<__nv_bfloat16*>(out), lse, hq, hk, bq, n_qb, C, ds, scale);
  } else {
    cudaError_t e =
        magi::allow_smem(block_sparse_fwd_kernel<float, D>, smem, &smem_ok);
    if (e != cudaSuccess) return (int)e;
    block_sparse_fwd_kernel<float, D><<<grid, BSP_NT, smem, (cudaStream_t)stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), tbl, static_cast<float*>(out), lse, hq,
        hk, bq, n_qb, C, ds, scale);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v,
             const int* tbl, void* out, float* lse, int hq, int hk, int bq,
             int n_qb, int C, int ds, float scale, void* stream) {
  if (hk <= 0 || hq % hk || bq <= 0 || n_qb <= 0 || C < 0 || ds <= 0)
    return (int)cudaErrorInvalidValue;
  switch (d) {
    case 64:
      return bsp_launch<T, 64>(q, k, v, tbl, out, lse, hq, hk, bq, n_qb, C,
                               ds, scale, stream);
    case 128:
      return bsp_launch<T, 128>(q, k, v, tbl, out, lse, hq, hk, bq, n_qb, C,
                                ds, scale, stream);
    case 256:
      return bsp_launch<T, 256>(q, k, v, tbl, out, lse, hq, hk, bq, n_qb, C,
                                ds, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [S, hq, d], k/v [S, hk, d] and out [S, hq, d] are contiguous rows of
// one dtype, 16-byte aligned; tbl [hk, n_qb, C] int32 chunk indices, each
// in [0, S / ds) (not checked here); lse [S, hq] float32. S = n_qb * bq.
extern "C" int block_sparse_fwd_f32(const void* q, const void* k,
                                    const void* v, const int* tbl, void* out,
                                    float* lse, int hq, int hk, int d, int bq,
                                    int n_qb, int C, int ds, float scale,
                                    void* stream) {
  return dispatch<float>(d, q, k, v, tbl, out, lse, hq, hk, bq, n_qb, C, ds,
                         scale, stream);
}

extern "C" int block_sparse_fwd_bf16(const void* q, const void* k,
                                     const void* v, const int* tbl,
                                     void* out, float* lse, int hq, int hk,
                                     int d, int bq, int n_qb, int C, int ds,
                                     float scale, void* stream) {
  return dispatch<__nv_bfloat16>(d, q, k, v, tbl, out, lse, hq, hk, bq, n_qb,
                                 C, ds, scale, stream);
}
