// NSA selected-branch backward over a chunk table, for Hopper (sm_90a):
// two walks, no atomics.
//
// Replaces: magiattention_tpu/kernels/block_sparse.py:_bsp_bwd_kernel
// (wrapper _bsp_bwd_pallas, pallas_call at block_sparse.py:383).
//
// What it computes: over the keys of each chunk table row (h, b), as in
// csrc/block_sparse_fwd.cu, with P = exp(s - lse) recomputed from the
// forward's natural-log lse, dP = dO.v, dS = P * (dP - delta) and delta =
// rowsum(dO * O) (computed outside, as the JAX package does):
//   dq[i] = scale * sum_j dS[i, j] k[j]          (per query row)
//   dk[j] = scale * sum_i dS[i, j] q[i]          (per key row of kv head h)
//   dv[j] = sum_i P[i, j] dO[i]
// summed over every (row, key slot) pair that reaches key row j, duplicate
// chunks included. All results are float32; dq is (S, hq, d), dk and dv are
// (S, hk, d), the k/v layout (the TPU's chunk view (n_chunks, ds, hk, d) is
// a reshape of it).
//
// Design. The TPU kernel's grid (hk, n_qb, C) runs in order: dq sits in
// VMEM scratch across a row's chunk steps, and dk/dv are revisit-
// accumulated into table-indexed windows, zeroed by the first visitor
// (first_visit_flags over an aliased zero background), with dk's ln2 fixed
// up on the host. Blocks on a GPU run in no order, so the backward is two
// launches, as the FFA split pair (B3, B5) is, each owning what it writes:
// - dq walk (block_sparse_bwd_dq_*), query-major: one CTA per 64 query
//   rows of one (kv head, q block), looping the row's keys 64 at a time
//   (the forward's gathered steps); dq stays on chip for the whole walk and
//   is written once.
// - dk/dv walk (block_sparse_bwd_dkv_*), key-major, over the table's
//   transpose (kernels/block_sparse.py:key_table): one CTA per 64
//   consecutive key rows of one kv head keeps K, V and the dk/dv sums on
//   chip and visits every q block whose table row names a chunk of its
//   tile. Per visit it loads the block's query rows, lse and delta (RowMap),
//   forms S^T and dP^T, weights each key row of P^T and dS^T by its
//   chunk's multiplicity in that row (0 where the row does not name the
//   chunk, 2 where it names it twice), and adds dV += (w P^T) dO and dK +=
//   scale (w dS^T) Q. dk and dv are written once. The CTAs take the (kv
//   head, key tile) pairs most visits first: NSA's picks cluster, and the
//   longest tiles must not form the tail.
// So every output is written by one CTA in a fixed order: dq, dk and dv are
// bitwise reproducible in both dtypes.
//
// Two bodies per walk:
// - bfloat16: csrc/block_sparse_tc.cuh on the tensor cores (wgmma, one
//   warpgroup; gathered rows by cp.async, double-buffered; dk/dv as hi + lo
//   products);
// - float32: the CUDA-core bodies below, for the 1e-5 gates. Each of the
//   256 threads computes a 4 x 4 block of S^T = K Q^T and dP^T = V dO^T (key
//   slots ty + 16 i, query rows tx + 16 j) and writes dS^T (and, key-major,
//   P^T) to shared memory; the dq walk then adds dq += dS K for its 4 query
//   rows x d/16 columns, the dk/dv walk dv += P^T dO and dk += dS^T Q for its
//   4 key rows x d/16 columns. The scale is applied in float32 (scores, and
//   dq / dk at their writes); no finite mask value: key slots past n_keys,
//   rows past the block and keys a row does not name get P = 0.
//
// What bounds it on this card: operations, 10 * d flops per (query row,
// key slot) pair (S, dP, P^T dO, dS^T Q, dS K): on the bf16 tensor cores
// (989 TFLOP/s on an H100 SXM) for bf16, on the CUDA cores (67 TFLOP/s)
// for float32; the two walks each recompute S and dP. Shared memory of the
// float32 bodies at d = 128: dq walk 153 KB (Q, dO, K, V at stride d + 4,
// the dS^T tile, the rows' lse and delta, 64 key rows), dk/dv walk 173 KB
// (K, V, Q, dO, the P^T and dS^T tiles, lse, delta, the weights): one CTA
// per SM; the bf16 bodies' in their header.
//
// At d = 256 every walk takes one 128-column half of what it writes (dq in
// grid z = row tile * 2 + half, dk and dv in grid y). The float32 bodies
// then chunk the contraction too: four 256-wide tiles would not fit, so
// each step loads Q, dO, K and V 128 columns at a time (the other half
// first, its own last) and adds each chunk's products into S^T and dP^T;
// the products after it read the chunks left in shared memory, its own
// half. Their tiles stay 128 wide.
#include <type_traits>

#include "block_sparse.cuh"
#include "block_sparse_tc.cuh"

namespace {

using magi::LOG2E;

template <int D>
struct DqSmemF32 {
  static constexpr int DS = BSP_DV<D> + 4;  // tiles are a chunk wide
  static constexpr int PSTR = BSP_ROWS + 16;  // row stride of dS^T
  static constexpr size_t bytes =
      sizeof(float) * (2 * BSP_ROWS * DS + 2 * BSP_KEYS * DS +
                       BSP_KEYS * PSTR + 2 * BSP_ROWS) +
      sizeof(int) * BSP_KEYS;
};

template <int D>
struct DkvSmemF32 {
  static constexpr int DS = BSP_DV<D> + 4;  // tiles are a chunk wide
  static constexpr int PSTR = BSP_ROWS + 16;  // row stride of P^T, dS^T
  static constexpr size_t bytes =
      sizeof(float) * (2 * BSP_KEYS * DS + 2 * BSP_ROWS * DS +
                       2 * BSP_KEYS * PSTR + 2 * BSP_ROWS + BSP_KEYS);
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

__device__ __forceinline__ void zero_blocks(float (&s)[4][4],
                                            float (&dp)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
}

// This thread's 4 x 4 blocks of S^T = K Q^T and dP^T = V dO^T, added to s
// and dp over the W columns of the tiles (row stride W + 4): key slots
// ty + 16 i (rows of Ks, Vs), query rows tx + 16 j (rows of Qs, dOs).
template <int W>
__device__ __forceinline__ void scores_t_acc(float (&s)[4][4],
                                             float (&dp)[4][4],
                                             const float* Ks, const float* Vs,
                                             const float* Qs,
                                             const float* dOs, int tx,
                                             int ty) {
  constexpr int DS = W + 4;
#pragma unroll 2
  for (int dd = 0; dd < W; dd += 4) {
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
      c4[j] = *reinterpret_cast<const float4*>(dOs + (tx + 16 * j) * DS + dd);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dp[i][j] = dot4(a[i], c4[j], dp[i][j]);
  }
}

template <int D>
__device__ __forceinline__ void scores_t(float (&s)[4][4], float (&dp)[4][4],
                                         const float* Ks, const float* Vs,
                                         const float* Qs, const float* dOs,
                                         int tx, int ty) {
  zero_blocks(s, dp);
  scores_t_acc<D>(s, dp, Ks, Vs, Qs, dOs, tx, ty);
}

// The dq walk, float32: one CTA per 64 query rows of (kv head, q block).
template <int D>
__global__ void __launch_bounds__(BSP_NT, 1)
    bsp_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ tbl, float* __restrict__ dq,
                      int hq, int hk, int bq, int n_qb, int C, int ds,
                      float scale) {
  constexpr int DC = BSP_DV<D>;  // tile width, and dq columns of this CTA
  constexpr int NC = BSP_NCH<D>;
  constexpr int DS = DqSmemF32<D>::DS;
  constexpr int PSTR = DqSmemF32<D>::PSTR;
  constexpr int CG = DC / 64;  // float4 column groups a thread owns
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + BSP_ROWS * DS;
  float* Ks = dOs + BSP_ROWS * DS;
  float* Vs = Ks + BSP_KEYS * DS;
  float* dSs = Vs + BSP_KEYS * DS;     // dS^T: key slots x query rows
  float* Ls = dSs + BSP_KEYS * PSTR;   // the rows' lse, log2 domain
  float* Dls = Ls + BSP_ROWS;          // the rows' delta
  int* krow = reinterpret_cast<int*>(Dls + BSP_ROWS);

  const int b = blockIdx.x, h = blockIdx.y;
  const int row0 = (int)(blockIdx.z / NC) * BSP_ROWS;
  const int ch = NC > 1 ? (int)(blockIdx.z % NC) : 0;  // the dq column half
  const int g = hq / hk;
  const RowMap rows{b, h, bq, g, hq, bq * g};
  const int n_keys = C * ds;
  const int* tbl_row = tbl + ((long)h * n_qb + b) * C;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const auto row_of = [&](int r) { return rows(row0 + r); };

  if constexpr (NC == 1) {
    load_rows<float, D>(Qs, q, row_of);
    load_rows<float, D>(dOs, dout, row_of);
  }
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

    {  // dS^T of this thread's 4 key slots x 4 query rows
      float s[4][4], dp[4][4];
      if constexpr (NC == 1) {
        load_rows<float, D>(Ks, k, keys);
        load_rows<float, D>(Vs, v, keys);
        __syncthreads();
        scores_t<D>(s, dp, Ks, Vs, Qs, dOs, tx, ty);
      } else {  // chunk by chunk, this CTA's half last
        zero_blocks(s, dp);
#pragma unroll 1
        for (int ci = 0; ci < NC; ++ci) {
          const int c = (ch + 1 + ci) % NC;  // ci = NC - 1: c = ch
          if (ci > 0) __syncthreads();  // the last chunk's products are done
          load_rows<float, DC, D>(Qs, q + c * DC, row_of);
          load_rows<float, DC, D>(dOs, dout + c * DC, row_of);
          load_rows<float, DC, D>(Ks, k + c * DC, keys);
          load_rows<float, DC, D>(Vs, v + c * DC, keys);
          __syncthreads();
          scores_t_acc<DC>(s, dp, Ks, Vs, Qs, dOs, tx, ty);
        }
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
          dSs[slot * PSTR + c] = p * (dp[i][j] - Dls[c]);
        }
      }
    }
    __syncthreads();  // dS^T is visible

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
    float* o = dq + row * D + ch * DC;
#pragma unroll
    for (int cg = 0; cg < CG; ++cg)
      *reinterpret_cast<float4*>(o + cg * 64 + tx * 4) = make_float4(
          dq_acc[i][cg * 4 + 0] * scale, dq_acc[i][cg * 4 + 1] * scale,
          dq_acc[i][cg * 4 + 2] * scale, dq_acc[i][cg * 4 + 3] * scale);
  }
}

// The dk/dv walk, float32: the (kv head, key tile) of CTA x is order[x] =
// h * n_tiles + kt; its visits are [vptr[p], vptr[p + 1]) of vq (q block)
// and vmult (M chunk multiplicities each: chunk kt * 64 / ds + m of the
// block's table row).
template <int D>
__global__ void __launch_bounds__(BSP_NT, 1)
    bsp_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const int* __restrict__ order,
                       const int* __restrict__ vptr,
                       const int* __restrict__ vq,
                       const int* __restrict__ vmult, float* __restrict__ dk,
                       float* __restrict__ dv, int hq, int hk, int bq, int S,
                       int ds, int M, int n_tiles, float scale) {
  constexpr int DC = BSP_DV<D>;  // tile width, and dk / dv columns of a CTA
  constexpr int NC = BSP_NCH<D>;
  constexpr int DS = DkvSmemF32<D>::DS;
  constexpr int PSTR = DkvSmemF32<D>::PSTR;
  constexpr int CG = DC / 64;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BSP_KEYS * DS;
  float* Qs = Vs + BSP_KEYS * DS;
  float* dOs = Qs + BSP_ROWS * DS;
  float* Ps = dOs + BSP_ROWS * DS;     // P^T: key slots x query rows
  float* dSs = Ps + BSP_KEYS * PSTR;   // dS^T
  float* Ls = dSs + BSP_KEYS * PSTR;   // the rows' lse, log2 domain
  float* Dls = Ls + BSP_ROWS;          // the rows' delta
  float* Ws = Dls + BSP_ROWS;          // the key rows' weights

  const int pair = order[blockIdx.x];
  const int h = pair / n_tiles, k0 = (pair % n_tiles) * BSP_KEYS;
  const int n_valid = min(BSP_KEYS, S - k0);
  const int g = hq / hk, r_total = bq * g;
  const int chunk0 = k0 / ds;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float qk_scale = scale * LOG2E;
  const int ch = NC > 1 ? (int)blockIdx.y : 0;  // the dk / dv column half

  const auto key_of = [&](int r) {
    return r < n_valid ? (long)(k0 + r) * hk + h : -1L;
  };
  if constexpr (NC == 1) {
    load_rows<float, D>(Ks, k, key_of);
    load_rows<float, D>(Vs, v, key_of);
  }

  float dk_acc[4][4 * CG], dv_acc[4][4 * CG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * CG; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int v_end = vptr[pair + 1];
  for (int vi = vptr[pair]; vi < v_end; ++vi) {
    const RowMap rows{vq[vi], h, bq, g, hq, r_total};
    for (int row0 = 0; row0 < r_total; row0 += BSP_ROWS) {
      const auto row_of = [&](int r) { return rows(row0 + r); };
      const auto load_stats = [&]() {
        if (tid < BSP_ROWS) {
          const long row = row_of(tid);
          Ls[tid] = row < 0 ? -INFINITY : lse[row] * LOG2E;  // -inf: dead
          Dls[tid] = row < 0 ? 0.f : delta[row];
        } else if (tid < BSP_ROWS + BSP_KEYS) {
          const int j = tid - BSP_ROWS;  // key rows past S weigh 0
          Ws[j] = j < n_valid
                      ? (float)vmult[(long)vi * M + (k0 + j) / ds - chunk0]
                      : 0.f;
        }
      };
      float s[4][4], dp[4][4];
      if constexpr (NC == 1) {
        __syncthreads();  // the previous step is done with its tiles
        load_rows<float, D>(Qs, q, row_of);
        load_rows<float, D>(dOs, dout, row_of);
        load_stats();
        __syncthreads();
        scores_t<D>(s, dp, Ks, Vs, Qs, dOs, tx, ty);
      } else {  // chunk by chunk, this CTA's half last
        zero_blocks(s, dp);
#pragma unroll 1
        for (int ci = 0; ci < NC; ++ci) {
          const int c = (ch + 1 + ci) % NC;  // ci = NC - 1: c = ch
          __syncthreads();  // the previous products are done with the tiles
          load_rows<float, DC, D>(Ks, k + c * DC, key_of);
          load_rows<float, DC, D>(Vs, v + c * DC, key_of);
          load_rows<float, DC, D>(Qs, q + c * DC, row_of);
          load_rows<float, DC, D>(dOs, dout + c * DC, row_of);
          if (ci == 0) load_stats();
          __syncthreads();
          scores_t_acc<DC>(s, dp, Ks, Vs, Qs, dOs, tx, ty);
        }
      }

      {  // P^T and dS^T of this thread's 4 key slots x 4 query rows
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int slot = ty + 16 * i;
          const float w = Ws[slot];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = tx + 16 * j;  // query row of the tile
            const float l = Ls[c];
            // a key its row does not name (w = 0) may score above the
            // row's lse: exp2 is not taken there
            const float p = w != 0.f && l != -INFINITY
                                ? w * exp2f(s[i][j] * qk_scale - l)
                                : 0.f;
            Ps[slot * PSTR + c] = p;
            dSs[slot * PSTR + c] = p * (dp[i][j] - Dls[c]);
          }
        }
      }
      __syncthreads();  // P^T and dS^T are visible

      // dv += P^T dO, dk += dS^T Q for this thread's 4 key slots
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
              dv_acc[i][cg * 4 + 0] = fmaf(p, ov.x, dv_acc[i][cg * 4 + 0]);
              dv_acc[i][cg * 4 + 1] = fmaf(p, ov.y, dv_acc[i][cg * 4 + 1]);
              dv_acc[i][cg * 4 + 2] = fmaf(p, ov.z, dv_acc[i][cg * 4 + 2]);
              dv_acc[i][cg * 4 + 3] = fmaf(p, ov.w, dv_acc[i][cg * 4 + 3]);
              dk_acc[i][cg * 4 + 0] = fmaf(d, qv.x, dk_acc[i][cg * 4 + 0]);
              dk_acc[i][cg * 4 + 1] = fmaf(d, qv.y, dk_acc[i][cg * 4 + 1]);
              dk_acc[i][cg * 4 + 2] = fmaf(d, qv.z, dk_acc[i][cg * 4 + 2]);
              dk_acc[i][cg * 4 + 3] = fmaf(d, qv.w, dk_acc[i][cg * 4 + 3]);
            }
          }
        }
      }
    }
  }

  // one write per (key tile, kv head); the scale folds into dk here
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= S) continue;
    float* pk = dk + ((long)row * hk + h) * D + ch * DC + tx * 4;
    float* pv = dv + ((long)row * hk + h) * D + ch * DC + tx * 4;
#pragma unroll
    for (int cg = 0; cg < CG; ++cg) {
      *reinterpret_cast<float4*>(pk + cg * 64) = make_float4(
          dk_acc[i][cg * 4 + 0] * scale, dk_acc[i][cg * 4 + 1] * scale,
          dk_acc[i][cg * 4 + 2] * scale, dk_acc[i][cg * 4 + 3] * scale);
      *reinterpret_cast<float4*>(pv + cg * 64) =
          make_float4(dv_acc[i][cg * 4 + 0], dv_acc[i][cg * 4 + 1],
                      dv_acc[i][cg * 4 + 2], dv_acc[i][cg * 4 + 3]);
    }
  }
}

template <typename T, int D>
int dq_launch(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, const int* tbl, float* dq,
              int hq, int hk, int bq, int n_qb, int C, int ds, float scale,
              void* stream) {
  static magi::SmemAllowed smem_ok;
  constexpr bool TC = !std::is_same<T, float>::value;
  const size_t smem = TC ? bsp_tc::DqSmem<D>::bytes : DqSmemF32<D>::bytes;
  const int r_total = bq * (hq / hk);
  const dim3 grid(n_qb, hk,
                  (r_total + BSP_ROWS - 1) / BSP_ROWS * BSP_NCH<D>);
  if constexpr (TC) {
    cudaError_t e =
        magi::allow_smem(bsp_tc::bsp_bwd_dq_tc_kernel<D>, smem, &smem_ok);
    if (e != cudaSuccess) return (int)e;
    bsp_tc::bsp_bwd_dq_tc_kernel<D><<<grid, 128, smem, (cudaStream_t)stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<const __nv_bfloat16*>(dout), lse, delta, tbl, dq, hq, hk,
        bq, n_qb, C, ds, scale);
  } else {
    cudaError_t e = magi::allow_smem(bsp_bwd_dq_kernel<D>, smem, &smem_ok);
    if (e != cudaSuccess) return (int)e;
    bsp_bwd_dq_kernel<D><<<grid, BSP_NT, smem, (cudaStream_t)stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, tbl, dq, hq, hk, bq, n_qb, C, ds, scale);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dkv_launch(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const int* order,
               const int* vptr, const int* vq, const int* vmult, float* dk,
               float* dv, int hq, int hk, int bq, int S, int ds, int M,
               int n_tiles, float scale, void* stream) {
  static magi::SmemAllowed smem_ok;
  constexpr bool TC = !std::is_same<T, float>::value;
  const size_t smem = TC ? bsp_tc::DkvSmem<D>::bytes : DkvSmemF32<D>::bytes;
  const dim3 grid(hk * n_tiles, BSP_NCH<D>);
  if constexpr (TC) {
    cudaError_t e =
        magi::allow_smem(bsp_tc::bsp_bwd_dkv_tc_kernel<D>, smem, &smem_ok);
    if (e != cudaSuccess) return (int)e;
    bsp_tc::bsp_bwd_dkv_tc_kernel<D><<<grid, 128, smem, (cudaStream_t)stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<const __nv_bfloat16*>(dout), lse, delta, order, vptr, vq,
        vmult, dk, dv, hq, hk, bq, S, ds, M, n_tiles, scale);
  } else {
    cudaError_t e = magi::allow_smem(bsp_bwd_dkv_kernel<D>, smem, &smem_ok);
    if (e != cudaSuccess) return (int)e;
    bsp_bwd_dkv_kernel<D><<<grid, BSP_NT, smem, (cudaStream_t)stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, order, vptr, vq, vmult, dk, dv, hq, hk, bq, S, ds, M, n_tiles,
        scale);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dq_dispatch(int d, const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                const int* tbl, float* dq, int hq, int hk, int bq, int n_qb,
                int C, int ds, float scale, void* stream) {
  if (hk <= 0 || hq % hk || bq <= 0 || n_qb <= 0 || C < 0 || ds <= 0)
    return (int)cudaErrorInvalidValue;
  switch (d) {
    case 64:
      return dq_launch<T, 64>(q, k, v, dout, lse, delta, tbl, dq, hq, hk, bq,
                              n_qb, C, ds, scale, stream);
    case 128:
      return dq_launch<T, 128>(q, k, v, dout, lse, delta, tbl, dq, hq, hk, bq,
                               n_qb, C, ds, scale, stream);
    case 256:
      return dq_launch<T, 256>(q, k, v, dout, lse, delta, tbl, dq, hq, hk, bq,
                               n_qb, C, ds, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dkv_dispatch(int d, const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 const int* order, const int* vptr, const int* vq,
                 const int* vmult, float* dk, float* dv, int hq, int hk,
                 int bq, int S, int ds, int M, int n_tiles, float scale,
                 void* stream) {
  if (hk <= 0 || hq % hk || bq <= 0 || S <= 0 || ds <= 0 || M <= 0 ||
      n_tiles != (S + BSP_KEYS - 1) / BSP_KEYS)
    return (int)cudaErrorInvalidValue;
  switch (d) {
    case 64:
      return dkv_launch<T, 64>(q, k, v, dout, lse, delta, order, vptr, vq,
                               vmult, dk, dv, hq, hk, bq, S, ds, M, n_tiles,
                               scale, stream);
    case 128:
      return dkv_launch<T, 128>(q, k, v, dout, lse, delta, order, vptr, vq,
                                vmult, dk, dv, hq, hk, bq, S, ds, M, n_tiles,
                                scale, stream);
    case 256:
      return dkv_launch<T, 256>(q, k, v, dout, lse, delta, order, vptr, vq,
                                vmult, dk, dv, hq, hk, bq, S, ds, M, n_tiles,
                                scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int D>
long smem_of(bool dkv, bool tc) {
  if (dkv) return (long)(tc ? bsp_tc::DkvSmem<D>::bytes : DkvSmemF32<D>::bytes);
  return (long)(tc ? bsp_tc::DqSmem<D>::bytes : DqSmemF32<D>::bytes);
}

}  // namespace

// The dq walk. q/dout [S, hq, d], k/v [S, hk, d]: contiguous rows of one
// dtype, 16-byte aligned; lse, delta [S, hq] float32; tbl [hk, n_qb, C]
// int32 chunk indices in [0, S / ds) (not checked here). dq [S, hq, d]
// float32, every row written.
extern "C" int block_sparse_bwd_dq_f32(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* delta,
                                       const int* tbl, float* dq, int hq,
                                       int hk, int d, int bq, int n_qb, int C,
                                       int ds, float scale, void* stream) {
  return dq_dispatch<float>(d, q, k, v, dout, lse, delta, tbl, dq, hq, hk, bq,
                            n_qb, C, ds, scale, stream);
}

extern "C" int block_sparse_bwd_dq_bf16(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const float* lse, const float* delta,
                                        const int* tbl, float* dq, int hq,
                                        int hk, int d, int bq, int n_qb, int C,
                                        int ds, float scale, void* stream) {
  return dq_dispatch<__nv_bfloat16>(d, q, k, v, dout, lse, delta, tbl, dq, hq,
                                    hk, bq, n_qb, C, ds, scale, stream);
}

// The dk/dv walk over the transposed table (kernels/block_sparse.py:
// key_table): order [hk * n_tiles] and vptr [hk * n_tiles + 1] int32, vq
// [V] int32 q blocks, vmult [V, M] int32 multiplicities (not checked
// here). dk/dv [S, hk, d] float32, every row written. n_tiles = ceil(S /
// 64).
extern "C" int block_sparse_bwd_dkv_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const int* order, const int* vptr,
    const int* vq, const int* vmult, float* dk, float* dv, int hq, int hk,
    int d, int bq, int S, int ds, int M, int n_tiles, float scale,
    void* stream) {
  return dkv_dispatch<float>(d, q, k, v, dout, lse, delta, order, vptr, vq,
                             vmult, dk, dv, hq, hk, bq, S, ds, M, n_tiles,
                             scale, stream);
}

extern "C" int block_sparse_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const int* order, const int* vptr,
    const int* vq, const int* vmult, float* dk, float* dv, int hq, int hk,
    int d, int bq, int S, int ds, int M, int n_tiles, float scale,
    void* stream) {
  return dkv_dispatch<__nv_bfloat16>(d, q, k, v, dout, lse, delta, order,
                                     vptr, vq, vmult, dk, dv, hq, hk, bq, S,
                                     ds, M, n_tiles, scale, stream);
}

// The dynamic shared memory one CTA of the dq walk (dkv 0) or the dk/dv
// walk (dkv 1) takes at head dim d (bf16 1: the tensor-core bodies,
// float32 0); 0 where no instance is compiled.
// utils/mem_budget.py:block_sparse_smem_bytes is its host model.
extern "C" long block_sparse_bwd_smem_bytes(int d, int dkv, int bf16) {
  switch (d) {
    case 64:
      return smem_of<64>(dkv != 0, bf16 != 0);
    case 128:
      return smem_of<128>(dkv != 0, bf16 != 0);
    case 256:
      return smem_of<256>(dkv != 0, bf16 != 0);
    default:
      return 0;
  }
}
