// The float32 online-softmax step of one 64 x 64 tile on the CUDA cores,
// used by csrc/block_sparse_fwd.cu (B13): the FFA forward's per-item step
// before the forward moved to the tensor cores (csrc/ffa_fwd_tc.cuh for
// bf16, csrc/ffa_fwd_tf32.cuh for float32).
//
// Per tile: S = Q K^T with float32 FMAs (each of 256 threads owns a 4 x 4
// block of S, rows ty + 16 i, cols tx + 16 j), scaled to the exp2 domain
// (scale * log2(e) applied to the float32 scores, never to a rounded copy
// of q), softcapped and masked by the work item unless it is IS_FULL
// (scores); the online softmax of the running max, sum and accumulator in
// registers, P to shared memory (softmax_update); acc += P V, each thread
// owning 4 rows x D/16 output columns (pv_accumulate). Tiles use row stride
// D + 4 so the 16-byte reads of 8 neighbouring threads hit distinct banks.
#pragma once

#include "common.cuh"

namespace {

using magi::LN2;
using magi::LOG2E;
using magi::META_DIM;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;

// One thread's running softmax state of one head: 4 rows, D/16 columns.
template <int D>
struct RowState {
  static constexpr int CG = D / 64;  // float4 column groups a thread owns
  float m[4], l[4], acc[4][4 * CG];
};

// s = Q K^T for this thread's 4 x 4 block, then scaled (log2 domain),
// softcapped and masked.
template <int D>
__device__ __forceinline__ void scores(float (&s)[4][4], const float* Qs,
                                       const float* Ks, int tx, int ty,
                                       float qk_scale, float softcap,
                                       const magi::Item& item, int q0,
                                       int k0) {
  constexpr int DS = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int dd = 0; dd < D; dd += 4) {
    float4 qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * DS + dd);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * DS + dd);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a = s[i][j];
        a = fmaf(qv[i].x, kv[j].x, a);
        a = fmaf(qv[i].y, kv[j].y, a);
        a = fmaf(qv[i].z, kv[j].z, a);
        a = fmaf(qv[i].w, kv[j].w, a);
        s[i][j] = a;
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float x = s[i][j] * qk_scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap) * LOG2E;
      if (!item.full && !item.live(q0 + ty + 16 * i, k0 + tx + 16 * j))
        x = -INFINITY;
      s[i][j] = x;
    }
}

// online softmax of one item's scores; P goes to Ps. A row's 64 columns
// live in the 16 lanes sharing ty.
template <int D>
__device__ __forceinline__ void softmax_update(float (&s)[4][4],
                                               RowState<D>& st, float* Ps,
                                               int tx, int ty) {
  constexpr int PSTR = BK + 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(st.m[i], mx);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = exp2f(st.m[i] - m_use);  // 0 while the row is empty
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = exp2f(s[i][j] - m_use);
      s[i][j] = p;
      rs += p;
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      rs += __shfl_xor_sync(0xffffffffu, rs, off);
    st.l[i] = st.l[i] * alpha + rs;
    st.m[i] = m_new;
#pragma unroll
    for (int c = 0; c < 4 * RowState<D>::CG; ++c) st.acc[i][c] *= alpha;
#pragma unroll
    for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * PSTR + tx + 16 * j] = s[i][j];
  }
}

// acc += P V over the item's 64 k rows
template <int D>
__device__ __forceinline__ void pv_accumulate(RowState<D>& st, const float* Ps,
                                              const float* Vs, int tx,
                                              int ty) {
  constexpr int DS = D + 4;
  constexpr int PSTR = BK + 16;
  constexpr int CG = RowState<D>::CG;
#pragma unroll 2
  for (int kk = 0; kk < BK; kk += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * PSTR + kk);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int cg = 0; cg < CG; ++cg) {
        const float4 vv = *reinterpret_cast<const float4*>(
            Vs + (kk + e) * DS + cg * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = e == 0   ? pv[i].x
                          : e == 1 ? pv[i].y
                          : e == 2 ? pv[i].z
                                   : pv[i].w;
          st.acc[i][cg * 4 + 0] = fmaf(p, vv.x, st.acc[i][cg * 4 + 0]);
          st.acc[i][cg * 4 + 1] = fmaf(p, vv.y, st.acc[i][cg * 4 + 1]);
          st.acc[i][cg * 4 + 2] = fmaf(p, vv.z, st.acc[i][cg * 4 + 2]);
          st.acc[i][cg * 4 + 3] = fmaf(p, vv.w, st.acc[i][cg * 4 + 3]);
        }
      }
    }
  }
}

}  // namespace
