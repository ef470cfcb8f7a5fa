// NSA selected-branch backward over a chunk table, one pass, for Hopper
// (sm_90a).
//
// Replaces: magiattention_tpu/kernels/block_sparse.py:_bsp_bwd_kernel
// (wrapper _bsp_bwd_pallas, pallas_call at block_sparse.py:383).
//
// What it computes: over the keys of each chunk table row (h, b), as in
// csrc/block_sparse_fwd.cu, with P = exp(s - lse) recomputed from the
// forward's natural-log lse, dP = dO.v, dS = P * (dP - delta) and delta =
// rowsum(dO * O) (computed outside, as the JAX package does):
//   dq[i] = scale * sum_j dS[i, j] k[j]          (per query row)
//   dk[j] += scale * sum_i dS[i, j] q[i]          (per key row of kv head h)
//   dv[j] += sum_i P[i, j] dO[i]
// summed over every (row, key slot) pair that reaches key row j, duplicate
// chunks included. All results are float32; dq is (S, hq, d), dk and dv are
// (S, hk, d), the k/v layout (the TPU's chunk view (n_chunks, ds, hk, d) is
// a reshape of it).
//
// Design. The TPU kernel's grid (hk, n_qb, C) runs in order: dq sits in
// VMEM scratch across a row's chunk steps, and dk/dv are revisit-
// accumulated into table-indexed windows, zeroed by the first visitor
// (first_visit_flags over an aliased zero background), with dk's ln2 fixed
// up on the host. Blocks on a GPU run in no order, so here ONE CTA owns 64
// query rows of one (kv head, q block) and loops over the row's keys, 64 at
// a time (the gathered K and V tiles, csrc/block_sparse.cuh): dq stays in
// registers for the whole walk and is written once, with no atomics; dk and
// dv of a step's 64 keys are formed in registers and added with float32
// atomics into zeroed (S, hk, d) buffers, since many q blocks select the
// same key. The atomics make dk and dv not bitwise reproducible (the order
// of the adds changes from run to run); dq is. Per step each of the 256
// threads computes a 4 x 4 block of S^T = K Q^T and dP^T = V dO^T (key
// slots ty + 16 i, query rows tx + 16 j), writes P^T and dS^T to shared
// memory, then dv += P^T dO and dk += dS^T Q for its 4 key slots x d/16
// columns, and dq += dS K for its 4 query rows x d/16 columns. The scale is
// applied in float32 (scores, and dq / dk at their adds); no finite mask
// value: key slots past n_keys and rows past the block get P = 0.
//
// What bounds it on this card: operations, 10 * d flops per (query row,
// key slot) pair (S, dP, P^T dO, dS^T Q, dS K), on the CUDA cores in
// float32 (67 TFLOP/s peak on an H100 SXM) for bf16 inputs too; the
// atomics add 2 * d float adds per (key slot, q block) pair. Shared memory
// is 173 KB at d = 128 (Q, dO, K, V at stride d + 4, the P^T and dS^T
// tiles, the rows' lse and delta, 64 key rows), so one CTA runs per SM.
#include "block_sparse.cuh"

namespace {

using magi::LOG2E;

template <int D>
struct BspBwdSmem {
  static constexpr int DS = D + 4;
  static constexpr int PSTR = BSP_ROWS + 16;  // row stride of P^T, dS^T
  static constexpr size_t bytes =
      sizeof(float) * (2 * BSP_ROWS * DS + 2 * BSP_KEYS * DS +
                       2 * BSP_KEYS * PSTR + 2 * BSP_ROWS) +
      sizeof(int) * BSP_KEYS;
};

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float lane(const float4& a, int e) {
  return e == 0 ? a.x : e == 1 ? a.y : e == 2 ? a.z : a.w;
}

template <typename T, int D>
__global__ void __launch_bounds__(BSP_NT, 1)
    block_sparse_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            const int* __restrict__ tbl,
                            float* __restrict__ dq, float* __restrict__ dk,
                            float* __restrict__ dv, int hq, int hk, int bq,
                            int n_qb, int C, int ds, float scale) {
  constexpr int DS = BspBwdSmem<D>::DS;
  constexpr int PSTR = BspBwdSmem<D>::PSTR;
  constexpr int CG = D / 64;  // float4 column groups a thread owns
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + BSP_ROWS * DS;
  float* Ks = dOs + BSP_ROWS * DS;
  float* Vs = Ks + BSP_KEYS * DS;
  float* Ps = Vs + BSP_KEYS * DS;      // P^T: key slots x query rows
  float* dSs = Ps + BSP_KEYS * PSTR;   // dS^T
  float* Ls = dSs + BSP_KEYS * PSTR;   // the rows' lse, log2 domain
  float* Dls = Ls + BSP_ROWS;          // the rows' delta
  int* krow = reinterpret_cast<int*>(Dls + BSP_ROWS);

  const int b = blockIdx.x, h = blockIdx.y;
  const int row0 = blockIdx.z * BSP_ROWS;
  const int g = hq / hk;
  const RowMap rows{b, h, bq, g, hq, bq * g};
  const int n_keys = C * ds;
  const int* tbl_row = tbl + ((long)h * n_qb + b) * C;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const auto row_of = [&](int r) { return rows(row0 + r); };

  load_rows<T, D>(Qs, q, row_of);
  load_rows<T, D>(dOs, dout, row_of);
  if (tid < BSP_ROWS) {
    const long row = row_of(tid);
    Ls[tid] = row < 0 ? -INFINITY : lse[row] * LOG2E;  // -inf: dead row
    Dls[tid] = row < 0 ? 0.f : delta[row];
  }
  const float qk_scale = scale * LOG2E;
  const KeyMap keys{krow, h, hk};

  float dq_acc[4][4 * CG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * CG; ++c) dq_acc[i][c] = 0.f;

  for (int k0 = 0; k0 < n_keys; k0 += BSP_KEYS) {
    __syncthreads();  // the previous step is done with the tiles and krow
    step_keys(krow, tbl_row, k0, n_keys, ds);
    __syncthreads();
    load_rows<T, D>(Ks, k, keys);
    load_rows<T, D>(Vs, v, keys);
    __syncthreads();

    {  // P^T and dS^T of this thread's 4 key slots x 4 query rows
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int dd = 0; dd < D; dd += 4) {
        float4 a[4], c4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(Ks + (ty + 16 * i) * DS + dd);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          c4[j] = *reinterpret_cast<const float4*>(Qs + (tx + 16 * j) * DS + dd);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = dot4(a[i], c4[j], s[i][j]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(Vs + (ty + 16 * i) * DS + dd);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          c4[j] =
              *reinterpret_cast<const float4*>(dOs + (tx + 16 * j) * DS + dd);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dp[i][j] = dot4(a[i], c4[j], dp[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int slot = ty + 16 * i;
        const bool key_live = k0 + slot < n_keys;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;  // query row of the tile
          const float l = Ls[c];
          const float p = key_live && l != -INFINITY
                              ? exp2f(s[i][j] * qk_scale - l)
                              : 0.f;
          Ps[slot * PSTR + c] = p;
          dSs[slot * PSTR + c] = p * (dp[i][j] - Dls[c]);
        }
      }
    }
    __syncthreads();  // P^T and dS^T are visible

    {  // dv += P^T dO, dk += dS^T Q for this thread's 4 key slots
      float dk_t[4][4 * CG], dv_t[4][4 * CG];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4 * CG; ++c) dk_t[i][c] = dv_t[i][c] = 0.f;
#pragma unroll 2
      for (int qq = 0; qq < BSP_ROWS; qq += 4) {
        float4 pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] =
              *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * PSTR + qq);
          dsv[i] =
              *reinterpret_cast<const float4*>(dSs + (ty + 16 * i) * PSTR + qq);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int cg = 0; cg < CG; ++cg) {
            const float4 ov = *reinterpret_cast<const float4*>(
                dOs + (qq + e) * DS + cg * 64 + tx * 4);
            const float4 qv = *reinterpret_cast<const float4*>(
                Qs + (qq + e) * DS + cg * 64 + tx * 4);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float p = lane(pv[i], e), d = lane(dsv[i], e);
              dv_t[i][cg * 4 + 0] = fmaf(p, ov.x, dv_t[i][cg * 4 + 0]);
              dv_t[i][cg * 4 + 1] = fmaf(p, ov.y, dv_t[i][cg * 4 + 1]);
              dv_t[i][cg * 4 + 2] = fmaf(p, ov.z, dv_t[i][cg * 4 + 2]);
              dv_t[i][cg * 4 + 3] = fmaf(p, ov.w, dv_t[i][cg * 4 + 3]);
              dk_t[i][cg * 4 + 0] = fmaf(d, qv.x, dk_t[i][cg * 4 + 0]);
              dk_t[i][cg * 4 + 1] = fmaf(d, qv.y, dk_t[i][cg * 4 + 1]);
              dk_t[i][cg * 4 + 2] = fmaf(d, qv.z, dk_t[i][cg * 4 + 2]);
              dk_t[i][cg * 4 + 3] = fmaf(d, qv.w, dk_t[i][cg * 4 + 3]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long at = keys(ty + 16 * i);
        if (at < 0) continue;  // a key slot past n_keys
        float* pk = dk + at * D + tx * 4;
        float* pv = dv + at * D + tx * 4;
#pragma unroll
        for (int cg = 0; cg < CG; ++cg)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            atomicAdd(pk + cg * 64 + e, dk_t[i][cg * 4 + e] * scale);
            atomicAdd(pv + cg * 64 + e, dv_t[i][cg * 4 + e]);
          }
      }
    }

    // dq += dS K for this thread's 4 query rows (dS^T read by column)
#pragma unroll 4
    for (int kk = 0; kk < BSP_KEYS; ++kk) {
      float d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] = dSs[kk * PSTR + ty + 16 * i];
#pragma unroll
      for (int cg = 0; cg < CG; ++cg) {
        const float4 kv =
            *reinterpret_cast<const float4*>(Ks + kk * DS + cg * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dq_acc[i][cg * 4 + 0] = fmaf(d[i], kv.x, dq_acc[i][cg * 4 + 0]);
          dq_acc[i][cg * 4 + 1] = fmaf(d[i], kv.y, dq_acc[i][cg * 4 + 1]);
          dq_acc[i][cg * 4 + 2] = fmaf(d[i], kv.z, dq_acc[i][cg * 4 + 2]);
          dq_acc[i][cg * 4 + 3] = fmaf(d[i], kv.w, dq_acc[i][cg * 4 + 3]);
        }
      }
    }
  }

  // one write per query row; the scale folds in here
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long row = row_of(ty + 16 * i);
    if (row < 0) continue;
    float* o = dq + row * D;
#pragma unroll
    for (int cg = 0; cg < CG; ++cg)
      *reinterpret_cast<float4*>(o + cg * 64 + tx * 4) = make_float4(
          dq_acc[i][cg * 4 + 0] * scale, dq_acc[i][cg * 4 + 1] * scale,
          dq_acc[i][cg * 4 + 2] * scale, dq_acc[i][cg * 4 + 3] * scale);
  }
}

template <typename T, int D>
int bsp_launch(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const int* tbl,
               float* dq, float* dk, float* dv, int hq, int hk, int bq,
               int n_qb, int C, int ds, float scale, void* stream) {
  static bool smem_ok = false;
  const size_t smem = BspBwdSmem<D>::bytes;
  cudaError_t e =
      magi::allow_smem(block_sparse_bwd_kernel<T, D>, smem, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  const int r_total = bq * (hq / hk);
  const dim3 grid(n_qb, hk, (r_total + BSP_ROWS - 1) / BSP_ROWS);
  block_sparse_bwd_kernel<T, D><<<grid, BSP_NT, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, tbl,
      dq, dk, dv, hq, hk, bq, n_qb, C, ds, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v,
             const void* dout, const float* lse, const float* delta,
             const int* tbl, float* dq, float* dk, float* dv, int hq, int hk,
             int bq, int n_qb, int C, int ds, float scale, void* stream) {
  if (hk <= 0 || hq % hk || bq <= 0 || n_qb <= 0 || C < 0 || ds <= 0)
    return (int)cudaErrorInvalidValue;
  switch (d) {
    case 64:
      return bsp_launch<T, 64>(q, k, v, dout, lse, delta, tbl, dq, dk, dv, hq,
                               hk, bq, n_qb, C, ds, scale, stream);
    case 128:
      return bsp_launch<T, 128>(q, k, v, dout, lse, delta, tbl, dq, dk, dv,
                                hq, hk, bq, n_qb, C, ds, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q/dout [S, hq, d], k/v [S, hk, d]: contiguous rows of one dtype, 16-byte
// aligned; lse, delta [S, hq] float32; tbl [hk, n_qb, C] int32 chunk
// indices in [0, S / ds) (not checked here). Outputs float32: dq [S, hq, d]
// (every row written), dk/dv [S, hk, d] ZEROED by the caller (added to).
extern "C" int block_sparse_bwd_f32(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* delta,
                                    const int* tbl, float* dq, float* dk,
                                    float* dv, int hq, int hk, int d, int bq,
                                    int n_qb, int C, int ds, float scale,
                                    void* stream) {
  return dispatch<float>(d, q, k, v, dout, lse, delta, tbl, dq, dk, dv, hq,
                         hk, bq, n_qb, C, ds, scale, stream);
}

extern "C" int block_sparse_bwd_bf16(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     const int* tbl, float* dq, float* dk,
                                     float* dv, int hq, int hk, int d, int bq,
                                     int n_qb, int C, int ds, float scale,
                                     void* stream) {
  return dispatch<__nv_bfloat16>(d, q, k, v, dout, lse, delta, tbl, dq, dk,
                                 dv, hq, hk, bq, n_qb, C, ds, scale, stream);
}
