// The FFA forward kernel shared by csrc/ffa_fwd.cu (one q head per CTA,
// G = 1) and csrc/ffa_fwd_gqa.cu (G q heads of one GQA group per CTA, the
// port of the TPU's packed twin). Each source includes this header once and
// instantiates the kernel for its G; the per-head arithmetic is the same
// inline code in both, so a row's result does not depend on G.
//
// What it computes: for every q head h and q row i, softmax attention over
// the k rows j that some slice covers (slice rectangle intersected with the
// band d_lo <= j - i <= d_hi); out = P V, lse = log(sum exp(s)) in natural
// log. A row no slice covers gives out 0 and lse -inf. Optionally (G = 1)
// the per-(q tile, head) max of the scaled, softcapped logits over the
// live entries, in natural units (-inf where the tile has none).
//
// Design. The TPU kernel walks a sequential grid (hq, W) and carries a q
// tile's m/l/acc in VMEM scratch from its IS_FIRST item to its IS_LAST item.
// Blocks on a GPU run in no order, so here ONE CTA owns one (q tile, head
// block of G heads) and loops over that q tile's run of work items itself
// (run_ptr is the CSR offset array over the runs, kernels/ffa_plan.py). The
// running max, sum and output accumulator of each of its G heads stay in
// registers for the whole run, the output is written once, and no atomics
// are needed. CTAs take q tiles from the last to the first, so under a
// causal mask the longest runs start first.
//
// Per work item: the 64-row k tile goes to shared memory, S = Q K^T is
// computed with float32 FMAs (each of 256 threads owns a 4 x 4 block of S,
// rows ty + 16 i, cols tx + 16 j), masked unless the item is IS_FULL, the
// online softmax runs in the exp2 domain (scale * log2(e) applied to the
// float32 scores, never to a rounded copy of q), P goes to shared memory,
// and acc += P V (each thread owns 4 rows x D/16 columns of the output).
// G = 1: the v tile replaces the k tile in one buffer (86 KB of shared
// memory at D = 128, two CTAs per SM). G > 1: the k and v tiles are both
// resident and every head of the block reads them, so each K/V tile is
// loaded once per work item for G heads instead of G times; the G q tiles
// stay resident for the run (223 KB at D = 128, G = 4: one CTA per SM).
//
// What bounds it on this card: operations. Work is 4 * D flops per live
// (row, col) pair and head. It runs on the CUDA cores in float32 (67
// TFLOP/s peak on an H100 SXM), for bf16 inputs too; tensor cores (wgmma,
// 989 TFLOP/s in bf16) and TMA loads overlapped with compute are later
// work. The float32 path must stay on FMA, never TF32, to hold the serving
// replay tolerance. Tiles use row stride D + 4 so the 16-byte reads of 8
// neighbouring threads hit distinct banks.
#pragma once

#include "common.cuh"

namespace {

using magi::LN2;
using magi::LOG2E;
using magi::META_DIM;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;

template <int D, int G>
struct FwdSmem {
  static constexpr int DS = D + 4;      // row stride of the Q and K/V tiles
  static constexpr int PSTR = BK + 16;  // row stride of the P tile
  static constexpr int KV_TILES = G == 1 ? 1 : 2;
  static constexpr size_t bytes =
      sizeof(float) * (G * BQ * DS + KV_TILES * BK * DS + BQ * PSTR);
};

// One thread's running softmax state of one head: 4 rows, D/16 columns.
template <int D>
struct RowState {
  static constexpr int CG = D / 64;  // float4 column groups a thread owns
  float m[4], l[4], acc[4][4 * CG];
};

template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long row_stride, int n_valid) {
  magi::load_tile<T, D, NT>(dst, src, row_stride, n_valid);
}

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

template <typename T, int D>
__device__ __forceinline__ void write_rows(const RowState<D>& st, T* out,
                                           float* lse, int q0, int h,
                                           int sq, int hq, int tx, int ty) {
  constexpr int CG = RowState<D>::CG;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const bool empty = st.l[i] == 0.f;  // no slice covers this row
    T* o = out + ((long)row * hq + h) * D;
#pragma unroll
    for (int cg = 0; cg < CG; ++cg)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        magi::store_out(o + cg * 64 + tx * 4 + e,
                        empty ? 0.f : st.acc[i][cg * 4 + e] / st.l[i]);
    if (tx == 0)
      lse[(long)row * hq + h] =
          empty ? -INFINITY : (st.m[i] + log2f(st.l[i])) * LN2;
  }
}

// The tile's max logit of one head into *dst, natural units. Every thread
// calls it; red is 8 floats of shared memory no other thread reads now.
template <int D>
__device__ __forceinline__ void write_max_logit(const RowState<D>& st,
                                                float* red, float* dst,
                                                int tid) {
  float mx = fmaxf(fmaxf(st.m[0], st.m[1]), fmaxf(st.m[2], st.m[3]));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));  // the other ty
  if ((tid & 31) == 0) red[tid >> 5] = mx;
  __syncthreads();
  if (tid == 0) {
    float m = red[0];
#pragma unroll
    for (int w = 1; w < NT / 32; ++w) m = fmaxf(m, red[w]);
    *dst = m == -INFINITY ? -INFINITY : m * LN2;  // log2 domain -> natural
  }
  __syncthreads();
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(NT, G == 1 ? 2 : 1)
    ffa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out,
                   float* __restrict__ lse, float* __restrict__ max_logits,
                   const int* __restrict__ work_kt,
                   const int* __restrict__ meta,
                   const int* __restrict__ run_ptr, int sq, int sk, int hq,
                   int hk, int num_q_tiles, float scale, float softcap) {
  constexpr int DS = FwdSmem<D, G>::DS;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;  // G tiles
  float* Ks = Qs + G * BQ * DS;
  float* Vs = G == 1 ? Ks : Ks + BK * DS;  // G = 1: v replaces k
  float* Ps = Vs + BK * DS;

  const int qt = num_q_tiles - 1 - (int)blockIdx.x;
  const int h0 = blockIdx.y * G;  // the block's first q head
  const int hkv = h0 / (hq / hk);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = qt * BQ;
  const long q_rs = (long)hq * D, kv_rs = (long)hk * D;

#pragma unroll
  for (int h = 0; h < G; ++h)
    load_tile<T, D>(Qs + h * BQ * DS, q + ((long)q0 * hq + h0 + h) * D, q_rs,
                    min(BQ, sq - q0));

  RowState<D> st[G];
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      st[h].m[i] = -INFINITY;
      st[h].l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < 4 * RowState<D>::CG; ++c) st[h].acc[i][c] = 0.f;
    }
  // softcap-free scores go straight to the log2 domain; with a softcap the
  // tanh runs on the naturally scaled score first
  const float qk_scale = softcap > 0.f ? scale : scale * LOG2E;

  const int w_end = run_ptr[qt + 1];
  for (int w = run_ptr[qt]; w < w_end; ++w) {
    const magi::Item item(meta + (long)w * META_DIM);
    if (item.empty()) continue;  // dummy item of an uncovered tile
    const int k0 = work_kt[w] * BK;
    const int k_valid = min(BK, sk - k0);

    __syncthreads();  // the previous item's P V is done with Ks, Vs and Ps
    load_tile<T, D>(Ks, k + ((long)k0 * hk + hkv) * D, kv_rs, k_valid);
    if (G > 1)
      load_tile<T, D>(Vs, v + ((long)k0 * hk + hkv) * D, kv_rs, k_valid);
    __syncthreads();

#pragma unroll
    for (int h = 0; h < G; ++h) {
      float s[4][4];
      scores<D>(s, Qs + h * BQ * DS, Ks, tx, ty, qk_scale, softcap, item, q0,
                k0);
      softmax_update<D>(s, st[h], Ps, tx, ty);
      __syncthreads();  // P is visible (G = 1: S is done with the k tile)
      if (G == 1) {
        load_tile<T, D>(Vs, v + ((long)k0 * hk + hkv) * D, kv_rs, k_valid);
        __syncthreads();
      }
      pv_accumulate<D>(st[h], Ps, Vs, tx, ty);
      if (G > 1 && h + 1 < G) __syncthreads();  // P V is done with Ps
    }
  }

#pragma unroll
  for (int h = 0; h < G; ++h)
    write_rows<T, D>(st[h], out, lse, q0, h0 + h, sq, hq, tx, ty);
  if (max_logits != nullptr) {
    __syncthreads();  // the last P V is done with Ps
#pragma unroll
    for (int h = 0; h < G; ++h)
      write_max_logit<D>(st[h], Ps, max_logits + (long)qt * hq + h0 + h, tid);
  }
}

template <typename T, int D, int G>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           float* max_logits, const int* work_kt, const int* meta,
           const int* run_ptr, int sq, int sk, int hq, int hk,
           int num_q_tiles, float scale, float softcap, void* stream) {
  static bool smem_ok = false;
  const size_t smem = FwdSmem<D, G>::bytes;
  cudaError_t e = magi::allow_smem(ffa_fwd_kernel<T, D, G>, smem, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(num_q_tiles, hq / G);
  ffa_fwd_kernel<T, D, G><<<grid, NT, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, max_logits,
      work_kt, meta, run_ptr, sq, sk, hq, hk, num_q_tiles, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace
