// The float32 FFA dq backward kernel on the CUDA cores, shared by the
// float32 entries of csrc/ffa_bwd_dq.cu (one q head per CTA, G = 1) and
// csrc/ffa_bwd_dq_gqa.cu (G q heads of one GQA group per CTA, the port of
// the TPU's packed twin). Their bf16 entries run csrc/ffa_bwd_dq_tc.cuh on
// the tensor cores. Each source includes this header once and instantiates
// the kernel for its G; the per-head arithmetic is the same inline code in
// both, so a row's dq does not depend on G.
//
// What it computes: for every q head h and q row i,
//   dq[i] = scale * sum_j dS[i, j] k[j],   dS = P * (dP - delta[i]) (* dcap)
// over the k rows j that some slice covers (the forward's mask), with
// P = exp(s - lse[i]) recomputed from the forward's natural-log lse,
// s = scale * q.k (softcapped: s = cap * tanh(s / cap), and dcap = 1 -
// tanh^2 is the chain factor), dP = dO.v and delta = rowsum(dO * O)
// (csrc/ffa_bwd_delta.cu). A row no slice covers has lse = -inf: its P is
// exactly 0 and so is its dq. The result is float32.
//
// Design. The TPU kernel walks a sequential grid (hq, W) and carries a q
// tile's dq in VMEM scratch from its IS_FIRST item to its IS_LAST item.
// Here, as in the FFA forward, ONE CTA owns one (q tile, head block of G
// heads) and loops over that q tile's run of the SAME q-major plan
// (run_ptr), so dq stays in registers for the whole run, is written once,
// and needs no atomics: the result does not depend on the order in which
// CTAs run. CTAs take q tiles from the last to the first, so under a causal
// mask the longest runs start first. lse and delta are read from the
// forward's [sq, hq] float32 rows directly (the TPU's lanes-major tile
// packing of them is a TPU layout idiom).
//
// The G tiles of Q and of dO go to shared memory once. Per work item the k
// and v tiles go to shared memory, once for the G heads; for each head each
// of the 256 threads computes a 4 x 4 block of S and of dP with float32
// FMAs (rows ty + 16 i, cols tx + 16 j), masks unless the item is IS_FULL,
// forms dS and writes it to shared memory; then acc += dS K, each thread
// owning 4 rows x D/16 columns. The scores are scaled in float32 inside the
// kernel: the TPU kernel rounds a pre-scaled copy of q back to the input
// type (ffa.py:901-902), this one does not. There is no finite MASK_VALUE:
// masked entries and dead rows get P = 0 by a select. softmax_scale folds
// into the one write.
//
// What bounds it on this card: operations. Work is 6 * D flops per live
// (row, col) pair and head (S, dP and dS K), on the CUDA cores in float32
// (67 TFLOP/s peak on an H100 SXM): the float32 gate of 1e-5 against the
// plain version needs float32 FMA (TF32 or bf16 tensor-core products would
// not pass it). Shared memory per CTA is
// 4 * (2 * G * 64 + 2 * 64) * (D + 4) + 4 * 64 * 80 bytes (Q and dO of G
// heads, K, V, the 64 x 80 dS tile): 152 KB at D = 128, G = 1, so one CTA
// runs per SM.
//
// Head dim 256 (G = 1): four 256-wide tiles would take 266 KB, so the
// contraction is chunked and the output split. The CTA takes one
// 128-column half of dq (grid z); per item it loads Q, dO, K and V 128
// columns at a time (the other half first, its own last), adds each
// chunk's products into S and dP, and then dS K reads the K chunk left in
// shared memory, its own half. Tiles stay 128 wide (152 KB), and Q and dO
// are read again per item (L2).
#pragma once

#include "common.cuh"

namespace {

using magi::LOG2E;
using magi::META_DIM;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;

template <int D, int G>
struct DqSmem {
  static constexpr int W = D > 128 ? 128 : D;  // tile width (a chunk)
  static constexpr int DS = W + 4;      // row stride of Q, dO, K, V
  static constexpr int PSTR = BK + 16;  // row stride of the dS tile
  static constexpr size_t bytes =
      sizeof(float) * (2 * G * BQ * DS + 2 * BK * DS + BQ * PSTR);
};

// One thread's dq accumulator and row statistics of one head.
template <int D>
struct DqState {
  static constexpr int CG = D / 64;  // float4 column groups a thread owns
  float lse[4], delta[4], acc[4][4 * CG];
  bool dead[4];
};

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// s += Q K^T and dp += dO V^T of this thread's 4 x 4 block over the W
// columns of the tiles (row stride W + 4)
template <int W>
__device__ __forceinline__ void sdp_accumulate(float (&s)[4][4],
                                               float (&dp)[4][4],
                                               const float* Qs,
                                               const float* dOs,
                                               const float* Ks,
                                               const float* Vs, int tx,
                                               int ty) {
  constexpr int DS = W + 4;
#pragma unroll 2
  for (int dd = 0; dd < W; dd += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * DS + dd);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * DS + dd);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dot4(a[i], b[j], s[i][j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(dOs + (ty + 16 * i) * DS + dd);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(Vs + (tx + 16 * j) * DS + dd);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dp[i][j] = dot4(a[i], b[j], dp[i][j]);
  }
}

// dS of this thread's 4 x 4 block from its S and dP sums, into dSs
template <int D>
__device__ __forceinline__ void ds_finish(const DqState<D>& st,
                                          const float (&s)[4][4],
                                          const float (&dp)[4][4],
                                          float* dSs, int tx, int ty,
                                          bool capped, float qk_scale,
                                          float softcap,
                                          const magi::Item& item, int q0,
                                          int k0) {
  constexpr int PSTR = BK + 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float x = s[i][j] * qk_scale, dcap = 1.f;
      if (capped) {
        const float t = tanhf(x / softcap);
        x = softcap * t;
        dcap = 1.f - t * t;
      }
      const bool live =
          !st.dead[i] &&
          (item.full || item.live(q0 + ty + 16 * i, k0 + tx + 16 * j));
      const float p =
          live ? (capped ? expf(x - st.lse[i]) : exp2f(x - st.lse[i])) : 0.f;
      dSs[(ty + 16 * i) * PSTR + tx + 16 * j] =
          p * (dp[i][j] - st.delta[i]) * dcap;
    }
}

// dS of this thread's 4 x 4 block of one (item, head) into dSs
template <int D>
__device__ __forceinline__ void ds_block(const DqState<D>& st,
                                         const float* Qs, const float* dOs,
                                         const float* Ks, const float* Vs,
                                         float* dSs, int tx, int ty,
                                         bool capped, float qk_scale,
                                         float softcap,
                                         const magi::Item& item, int q0,
                                         int k0) {
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
  sdp_accumulate<D>(s, dp, Qs, dOs, Ks, Vs, tx, ty);
  ds_finish<D>(st, s, dp, dSs, tx, ty, capped, qk_scale, softcap, item, q0,
               k0);
}

// acc += dS K over the item's 64 k rows
template <int D>
__device__ __forceinline__ void dsk_accumulate(DqState<D>& st,
                                               const float* dSs,
                                               const float* Ks, int tx,
                                               int ty) {
  constexpr int DS = D + 4;
  constexpr int PSTR = BK + 16;
  constexpr int CG = DqState<D>::CG;
#pragma unroll 2
  for (int kk = 0; kk < BK; kk += 4) {
    float4 dsv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dsv[i] =
          *reinterpret_cast<const float4*>(dSs + (ty + 16 * i) * PSTR + kk);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int cg = 0; cg < CG; ++cg) {
        const float4 kv = *reinterpret_cast<const float4*>(
            Ks + (kk + e) * DS + cg * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float d = e == 0   ? dsv[i].x
                          : e == 1 ? dsv[i].y
                          : e == 2 ? dsv[i].z
                                   : dsv[i].w;
          st.acc[i][cg * 4 + 0] = fmaf(d, kv.x, st.acc[i][cg * 4 + 0]);
          st.acc[i][cg * 4 + 1] = fmaf(d, kv.y, st.acc[i][cg * 4 + 1]);
          st.acc[i][cg * 4 + 2] = fmaf(d, kv.z, st.acc[i][cg * 4 + 2]);
          st.acc[i][cg * 4 + 3] = fmaf(d, kv.w, st.acc[i][cg * 4 + 3]);
        }
      }
    }
  }
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(NT, 1)
    ffa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dq,
                      const int* __restrict__ work_kt,
                      const int* __restrict__ meta,
                      const int* __restrict__ run_ptr, int sq, int sk, int hq,
                      int hk, int num_q_tiles, float scale, float softcap) {
  constexpr int DC = DqSmem<D, G>::W;  // tile width
  constexpr int NC = D / DC;            // chunks of the contraction
  static_assert(NC == 1 || G == 1, "the chunked instance runs one head");
  constexpr int DS = DqSmem<D, G>::DS;
  constexpr int CG = DqState<DC>::CG;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // G tiles
  float* dOs = Qs + G * BQ * DS;    // G tiles
  float* Ks = dOs + G * BQ * DS;
  float* Vs = Ks + BK * DS;
  float* dSs = Vs + BK * DS;

  const int qt = num_q_tiles - 1 - (int)blockIdx.x;
  const int h0 = blockIdx.y * G;  // the block's first q head
  const int hkv = h0 / (hq / hk);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = qt * BQ;
  const long q_rs = (long)hq * D, kv_rs = (long)hk * D;
  const int q_valid = min(BQ, sq - q0);
  const int ch = NC > 1 ? (int)blockIdx.z : 0;  // the dq column half

  if constexpr (NC == 1) {
#pragma unroll
    for (int h = 0; h < G; ++h) {
      magi::load_tile<T, D, NT>(Qs + h * BQ * DS,
                                q + ((long)q0 * hq + h0 + h) * D, q_rs,
                                q_valid);
      magi::load_tile<T, D, NT>(dOs + h * BQ * DS,
                                dout + ((long)q0 * hq + h0 + h) * D, q_rs,
                                q_valid);
    }
  }

  // softcap-free scores go straight to the log2 domain, and lse with them;
  // with a softcap the tanh runs on the naturally scaled score
  const bool capped = softcap > 0.f;
  const float qk_scale = capped ? scale : scale * LOG2E;
  DqState<DC> st[G];
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      const long at = (long)row * hq + h0 + h;
      const float l = row < sq ? lse[at] : -INFINITY;
      st[h].dead[i] = l == -INFINITY;  // no slice covers the row (or past sq)
      st[h].lse[i] = capped ? l : l * LOG2E;
      st[h].delta[i] = row < sq ? delta[at] : 0.f;
#pragma unroll
      for (int c = 0; c < 4 * CG; ++c) st[h].acc[i][c] = 0.f;
    }

  const int w_end = run_ptr[qt + 1];
  for (int w = run_ptr[qt]; w < w_end; ++w) {
    const magi::Item item(meta + (long)w * META_DIM);
    if (item.empty()) continue;  // dummy item of an uncovered tile
    const int k0 = work_kt[w] * BK;
    const int k_valid = min(BK, sk - k0);

    if constexpr (NC == 1) {
      __syncthreads();  // the previous item's dS K is done with Ks and dSs
      magi::load_tile<T, D, NT>(Ks, k + ((long)k0 * hk + hkv) * D, kv_rs,
                                k_valid);
      magi::load_tile<T, D, NT>(Vs, v + ((long)k0 * hk + hkv) * D, kv_rs,
                                k_valid);
      __syncthreads();

#pragma unroll
      for (int h = 0; h < G; ++h) {
        ds_block<D>(st[h], Qs + h * BQ * DS, dOs + h * BQ * DS, Ks, Vs, dSs,
                    tx, ty, capped, qk_scale, softcap, item, q0, k0);
        __syncthreads();  // dS is visible
        dsk_accumulate<D>(st[h], dSs, Ks, tx, ty);
        if (h + 1 < G) __syncthreads();  // dS K is done with dSs
      }
    } else {  // S and dP chunk by chunk, this CTA's half last
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 1
      for (int ci = 0; ci < NC; ++ci) {
        const int c = (ch + 1 + ci) % NC;  // ci = NC - 1: c = ch
        __syncthreads();  // the last products are done with the tiles
        magi::load_tile<T, DC, NT>(Qs, q + ((long)q0 * hq + h0) * D + c * DC,
                                   q_rs, q_valid);
        magi::load_tile<T, DC, NT>(
            dOs, dout + ((long)q0 * hq + h0) * D + c * DC, q_rs, q_valid);
        magi::load_tile<T, DC, NT>(Ks, k + ((long)k0 * hk + hkv) * D + c * DC,
                                   kv_rs, k_valid);
        magi::load_tile<T, DC, NT>(Vs, v + ((long)k0 * hk + hkv) * D + c * DC,
                                   kv_rs, k_valid);
        __syncthreads();
        sdp_accumulate<DC>(s, dp, Qs, dOs, Ks, Vs, tx, ty);
      }
      ds_finish<DC>(st[0], s, dp, dSs, tx, ty, capped, qk_scale, softcap,
                    item, q0, k0);
      __syncthreads();  // dS is visible
      dsk_accumulate<DC>(st[0], dSs, Ks, tx, ty);
    }
  }

  // the scale folds into the one write (dS carries none)
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      if (row >= sq) continue;
      float* o = dq + ((long)row * hq + h0 + h) * D + ch * DC;
#pragma unroll
      for (int cg = 0; cg < CG; ++cg)
        *reinterpret_cast<float4*>(o + cg * 64 + tx * 4) =
            make_float4(st[h].acc[i][cg * 4 + 0] * scale,
                        st[h].acc[i][cg * 4 + 1] * scale,
                        st[h].acc[i][cg * 4 + 2] * scale,
                        st[h].acc[i][cg * 4 + 3] * scale);
    }
}

template <typename T, int D, int G>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, float* dq,
           const int* work_kt, const int* meta, const int* run_ptr, int sq,
           int sk, int hq, int hk, int num_q_tiles, float scale,
           float softcap, void* stream) {
  static magi::SmemAllowed smem_ok;
  const size_t smem = DqSmem<D, G>::bytes;
  cudaError_t e =
      magi::allow_smem(ffa_bwd_dq_kernel<T, D, G>, smem, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(num_q_tiles, hq / G, D / DqSmem<D, G>::W);
  ffa_bwd_dq_kernel<T, D, G><<<grid, NT, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, dq,
      work_kt, meta, run_ptr, sq, sk, hq, hk, num_q_tiles, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace
