// The float32 k-major FFA backward kernel on the CUDA cores, shared by the
// float32 entries of csrc/ffa_bwd_dkv.cu (dk, dv: the split backward's
// second pass) and csrc/ffa_bwd_fused.cu (dk, dv and dq in one pass); their
// bf16 entries run csrc/bwd_kv_tc.cuh on the tensor cores. Each source
// includes this header once and instantiates the kernel with FUSED false
// or true; the body is the same up to the dq block that FUSED adds.
//
// What it computes: for every kv head and k row j, over the q rows i that
// some slice lets see j, and over the g = hq / hk query heads h of that kv
// head,
//   dv[j] = sum_h sum_i P[h, i, j] dO[h, i]
//   dk[j] = scale * sum_h sum_i dS[h, i, j] q[h, i]
// with P = exp(s - lse[i]) recomputed from the forward's natural-log lse,
// dS = P * (dP - delta[i]) (* dcap under a softcap), as in
// csrc/ffa_bwd_dq.cu. A k tile that no slice reaches, and every k row no
// live pair touches, gets exact zeros. Results are float32.
//
// Design. The TPU kernel's grid (hk, W, g) carries a k tile's dk/dv in
// VMEM scratch from its IS_FIRST item to its IS_LAST item, with the group
// innermost. Here ONE CTA owns one (k tile, kv head) and loops over that k
// tile's run of the k-major plan (work_qt_t, meta_t, run_ptr_t); inside
// each work item it loops the g query heads, so K and V are read once per
// CTA and stay in shared memory while Q and dO are read per head. dk and
// dv stay in registers for the whole run (each thread owns 4 k rows x D/16
// columns of each) and are written once per (k tile, kv head): the packed
// semantics of the GQA twin, with no atomics and no host reshape-sum, so
// the result is deterministic. CTAs take k tiles from the first to the
// last, so under a causal mask the longest runs start first.
//
// Per (item, head): each of the 256 threads computes a 4 x 4 block of
// S^T = K Q^T and of dP^T = V dO^T (k rows ty + 16 i, q cols tx + 16 j)
// with float32 FMAs, masks unless the item is IS_FULL, writes P^T and dS^T
// to shared memory, then accumulates dv += P^T dO and dk += dS^T Q. No
// finite MASK_VALUE: masked entries and rows with lse = -inf get P = 0.
//
// What bounds it on this card: operations. Work is 8 * D flops per live
// (row, col) pair and q head (S, dP, P^T dO, dS^T Q), on the CUDA cores in
// float32 (67 TFLOP/s peak on an H100 SXM): the float32 gate of 1e-5
// against the plain version needs float32 FMA. Shared memory per CTA is 173 KB at D = 128 (K, V, Q, dO at stride
// D + 4, the P^T and dS^T tiles, the tile's lse and delta) and a thread
// holds 64 accumulators, so one CTA runs per SM.
//
// FUSED adds dq from the same recompute: after the dk/dv products of an
// (item, head), dq[i] += sum_j dS[i, j] K[j] is formed from the dS^T tile
// already in shared memory and added with float32 atomics into a zeroed
// workspace (every k tile's CTA adds to the same q rows; there is no order
// between CTAs, so no owner could write dq once). A convert pass
// (csrc/ffa_bwd_fused.cu) multiplies the workspace by the scale. That is 5
// tile products per (item, head) where the split path spends 7, and adds
// no shared memory: the dS^T and K tiles the products read are already
// resident.
//
// Head dim 256: four 256-wide tiles would take 266 KB, so the contraction
// is chunked and the output split. The CTA takes one 128-column half of dk
// and dv (grid z; with FUSED, of dq's atomics too); per (item, head) it
// loads K, V, Q and dO 128 columns at a time (the other half first, its
// own last), adds each chunk's products into S^T and dP^T, and then the
// dV, dK (and dQ) products read the chunks left in shared memory, its own
// half. Tiles stay 128 wide (173 KB); K and V are read again per (item,
// head) instead of once per CTA (L2).
#pragma once

#include "common.cuh"

namespace {

using magi::LOG2E;
using magi::META_DIM;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;

template <int D>
struct DkvSmem {
  static constexpr int W = D > 128 ? 128 : D;  // tile width (a chunk)
  static constexpr int DS = W + 4;      // row stride of K, V, Q, dO
  static constexpr int PSTR = BQ + 16;  // row stride of the P^T, dS^T tiles
  static constexpr size_t bytes =
      sizeof(float) * (2 * BK * DS + 2 * BQ * DS + 2 * BK * PSTR + 2 * BQ);
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

// s += K Q^T and dp += V dO^T of this thread's 4 x 4 block (k rows ty +
// 16 i, q cols tx + 16 j) over the W columns of the tiles (row stride W +
// 4)
template <int W>
__device__ __forceinline__ void st_dpt_accumulate(float (&s)[4][4],
                                                  float (&dp)[4][4],
                                                  const float* Ks,
                                                  const float* Vs,
                                                  const float* Qs,
                                                  const float* dOs, int tx,
                                                  int ty) {
  constexpr int DS = W + 4;
#pragma unroll 2
  for (int dd = 0; dd < W; dd += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(Ks + (ty + 16 * i) * DS + dd);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(Qs + (tx + 16 * j) * DS + dd);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dot4(a[i], b[j], s[i][j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(Vs + (ty + 16 * i) * DS + dd);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(dOs + (tx + 16 * j) * DS + dd);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dp[i][j] = dot4(a[i], b[j], dp[i][j]);
  }
}

template <typename T, int D, bool FUSED>
__global__ void __launch_bounds__(NT, 1)
    ffa_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv,
                      float* __restrict__ dq_acc,
                      const int* __restrict__ work_qt_t,
                      const int* __restrict__ meta_t,
                      const int* __restrict__ run_ptr_t, int sq, int sk,
                      int hq, int hk, float scale, float softcap) {
  constexpr int DC = DkvSmem<D>::W;  // tile width
  constexpr int NC = D / DC;         // chunks of the contraction
  constexpr int DS = DkvSmem<D>::DS;
  constexpr int PSTR = DkvSmem<D>::PSTR;
  constexpr int CG = DC / 64;  // float4 column groups a thread owns
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * DS;
  float* Qs = Vs + BK * DS;
  float* dOs = Qs + BQ * DS;
  float* Ps = dOs + BQ * DS;    // P^T: k rows x q cols
  float* dSs = Ps + BK * PSTR;  // dS^T
  float* Ls = dSs + BK * PSTR;  // the q tile's lse (exp domain of p)
  float* Dls = Ls + BQ;         // the q tile's delta

  const int kt = blockIdx.x;
  const int hkv = blockIdx.y;
  const int g = hq / hk;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = kt * BK;
  const long q_rs = (long)hq * D, kv_rs = (long)hk * D;
  const int k_valid = min(BK, sk - k0);
  const int ch = NC > 1 ? (int)blockIdx.z : 0;  // the dk / dv column half

  if constexpr (NC == 1) {
    magi::load_tile<T, D, NT>(Ks, k + ((long)k0 * hk + hkv) * D, kv_rs,
                              k_valid);
    magi::load_tile<T, D, NT>(Vs, v + ((long)k0 * hk + hkv) * D, kv_rs,
                              k_valid);
  }

  const bool capped = softcap > 0.f;
  const float qk_scale = capped ? scale : scale * LOG2E;

  float dk_acc[4][4 * CG], dv_acc[4][4 * CG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * CG; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int w_end = run_ptr_t[kt + 1];
  for (int w = run_ptr_t[kt]; w < w_end; ++w) {
    const magi::Item item(meta_t + (long)w * META_DIM);
    if (item.empty()) continue;  // dummy item of a tile no slice reaches
    const int q0 = work_qt_t[w] * BQ;
    const int q_valid = min(BQ, sq - q0);

    for (int gi = 0; gi < g; ++gi) {
      const int h = hkv * g + gi;
      // this head's q tile's lse and delta (at the first chunk's loads)
      const auto load_stats = [&]() {
        if (tid < BQ) {
          const int row = q0 + tid;
          const float l = row < sq ? lse[(long)row * hq + h] : -INFINITY;
          Ls[tid] = capped ? l : l * LOG2E;
          Dls[tid] = row < sq ? delta[(long)row * hq + h] : 0.f;
        }
      };
      float s[4][4], dp[4][4];
      if constexpr (NC == 1) {
        __syncthreads();  // the previous head's products are done with smem
        magi::load_tile<T, D, NT>(Qs, q + ((long)q0 * hq + h) * D, q_rs,
                                  q_valid);
        magi::load_tile<T, D, NT>(dOs, dout + ((long)q0 * hq + h) * D, q_rs,
                                  q_valid);
        load_stats();
        __syncthreads();

#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
        st_dpt_accumulate<D>(s, dp, Ks, Vs, Qs, dOs, tx, ty);
      } else {  // chunk by chunk, this CTA's half last: its K, V, Q and
                // dO stay in shared memory for the products below
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 1
        for (int ci = 0; ci < NC; ++ci) {
          const int c = (ch + 1 + ci) % NC;  // ci = NC - 1: c = ch
          __syncthreads();  // the previous products are done with smem
          magi::load_tile<T, DC, NT>(
              Ks, k + ((long)k0 * hk + hkv) * D + c * DC, kv_rs, k_valid);
          magi::load_tile<T, DC, NT>(
              Vs, v + ((long)k0 * hk + hkv) * D + c * DC, kv_rs, k_valid);
          magi::load_tile<T, DC, NT>(
              Qs, q + ((long)q0 * hq + h) * D + c * DC, q_rs, q_valid);
          magi::load_tile<T, DC, NT>(
              dOs, dout + ((long)q0 * hq + h) * D + c * DC, q_rs, q_valid);
          if (ci == 0) load_stats();
          __syncthreads();
          st_dpt_accumulate<DC>(s, dp, Ks, Vs, Qs, dOs, tx, ty);
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;  // q row of the tile
          const float l = Ls[c];
          float x = s[i][j] * qk_scale, dcap = 1.f;
          if (capped) {
            const float t = tanhf(x / softcap);
            x = softcap * t;
            dcap = 1.f - t * t;
          }
          const bool live = l != -INFINITY &&
                            (item.full || item.live(q0 + c, k0 + ty + 16 * i));
          const float p = live ? (capped ? expf(x - l) : exp2f(x - l)) : 0.f;
          Ps[(ty + 16 * i) * PSTR + c] = p;
          dSs[(ty + 16 * i) * PSTR + c] = p * (dp[i][j] - Dls[c]) * dcap;
        }
      __syncthreads();  // P^T and dS^T are visible

#pragma unroll 2
      for (int qq = 0; qq < BQ; qq += 4) {
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

      if constexpr (FUSED) {
        // dq[q0 + r, h] += dS[r, :] K, straight into the float32 workspace
        // (softmax_scale is applied by the convert pass). Each thread owns
        // q rows ty + 16 i and 4 columns of one 64-column group at a time,
        // so only 16 partial sums are live beside dk/dv; rows outside the
        // item's slice rectangle get no contribution and are skipped.
#pragma unroll 1
        for (int cg = 0; cg < CG; ++cg) {
          float acc[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll 4
          for (int kk = 0; kk < BK; ++kk) {
            const float4 kv = *reinterpret_cast<const float4*>(
                Ks + kk * DS + cg * 64 + tx * 4);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float d = dSs[kk * PSTR + ty + 16 * i];
              acc[i][0] = fmaf(d, kv.x, acc[i][0]);
              acc[i][1] = fmaf(d, kv.y, acc[i][1]);
              acc[i][2] = fmaf(d, kv.z, acc[i][2]);
              acc[i][3] = fmaf(d, kv.w, acc[i][3]);
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = q0 + ty + 16 * i;
            if (row >= sq || row < item.qs || row >= item.qe) continue;
            float* p = dq_acc + ((long)row * hq + h) * D + ch * DC + cg * 64 +
                       tx * 4;
            atomicAdd(p + 0, acc[i][0]);
            atomicAdd(p + 1, acc[i][1]);
            atomicAdd(p + 2, acc[i][2]);
            atomicAdd(p + 3, acc[i][3]);
          }
        }
      }
    }
  }

  // one write per (k tile, kv head); the scale folds into dk here
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= sk) continue;
    float* ok = dk + ((long)row * hk + hkv) * D + ch * DC;
    float* ov = dv + ((long)row * hk + hkv) * D + ch * DC;
#pragma unroll
    for (int cg = 0; cg < CG; ++cg) {
      const int c = cg * 4;
      *reinterpret_cast<float4*>(ok + cg * 64 + tx * 4) = make_float4(
          dk_acc[i][c] * scale, dk_acc[i][c + 1] * scale,
          dk_acc[i][c + 2] * scale, dk_acc[i][c + 3] * scale);
      *reinterpret_cast<float4*>(ov + cg * 64 + tx * 4) = make_float4(
          dv_acc[i][c], dv_acc[i][c + 1], dv_acc[i][c + 2], dv_acc[i][c + 3]);
    }
  }
}

template <typename T, int D, bool FUSED>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, float* dk, float* dv,
           float* dq_acc, const int* work_qt_t, const int* meta_t,
           const int* run_ptr_t, int sq, int sk, int hq, int hk,
           int num_k_tiles, float scale, float softcap, void* stream) {
  static bool smem_ok = false;
  const size_t smem = DkvSmem<D>::bytes;
  cudaError_t e =
      magi::allow_smem(ffa_bwd_kv_kernel<T, D, FUSED>, smem, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(num_k_tiles, hk, D / DkvSmem<D>::W);
  ffa_bwd_kv_kernel<T, D, FUSED><<<grid, NT, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, dk,
      dv, dq_acc, work_qt_t, meta_t, run_ptr_t, sq, sk, hq, hk, scale,
      softcap);
  return (int)cudaGetLastError();
}

template <typename T, bool FUSED>
int dispatch(int d, const void* q, const void* k, const void* v,
             const void* dout, const float* lse, const float* delta,
             float* dk, float* dv, float* dq_acc, const int* work_qt_t,
             const int* meta_t, const int* run_ptr_t, int sq, int sk, int hq,
             int hk, int num_k_tiles, float scale, float softcap,
             void* stream) {
  switch (d) {
    case 64:
      return launch<T, 64, FUSED>(q, k, v, dout, lse, delta, dk, dv, dq_acc,
                                  work_qt_t, meta_t, run_ptr_t, sq, sk, hq,
                                  hk, num_k_tiles, scale, softcap, stream);
    case 128:
      return launch<T, 128, FUSED>(q, k, v, dout, lse, delta, dk, dv, dq_acc,
                                   work_qt_t, meta_t, run_ptr_t, sq, sk, hq,
                                   hk, num_k_tiles, scale, softcap, stream);
    case 256:
      return launch<T, 256, FUSED>(q, k, v, dout, lse, delta, dk, dv, dq_acc,
                                   work_qt_t, meta_t, run_ptr_t, sq, sk, hq,
                                   hk, num_k_tiles, scale, softcap, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
