// The body shared by the three paged-decode kernels for Hopper (sm_90a):
// paged_decode.cu (B10, one query row per slot), paged_decode_spec.cu (B11,
// spec_k draft rows per slot, a causal horizon per row) and
// paged_decode_int8.cu (B12, int8 pages dequantized in the kernel).
//
// What it computes: for slot s, kv head h and CTA row r = t * g + j (draft
// token t of spec_k, query head h * g + j of the group), softmax attention
// of q[s, t, h * g + j] over k/v rows [0, limit) of that slot, where
// limit = lengths[s] - (spec_k - 1 - t) and row p lives in page
// page_table[s, p / ps] at row p % ps. A row with limit <= 0 gives out 0 and
// lse -inf; lse in natural log. With spec_k = 1 this is the one-row decode.
//
// Design. One CTA per (kv head, slot) holds the spec_k * g rows of that kv
// head (at most RMAX), which share every K/V read, as the TPU kernels' q
// tile does. The CTA walks the slot's page table in chunks of 64 tokens
// (four 16-row pages: a page alone is smaller than a useful tile), loads the
// chunk's K and V rows into shared memory as float32 (all loads of a chunk
// are in flight before the first is used; an int8 row is multiplied by its own
// page's (page, head) scale as it is converted), computes the rows x 64
// scores (a thread reads each K value once for all of its rows), updates the
// running max and sum per row in the exp2 domain (q scaled by softmax_scale
// * log2(e) in float32 inside the kernel), and accumulates P V with one
// output column per thread (the probabilities are stored token-major, so one
// 16-byte read brings four rows' values of a token). Lengths are read on the
// device, so one launch serves every tick. The walk stops at the longest
// row's horizon, ceil(length / ps) pages, and never reads a dead page or
// table entry; a shorter row masks its columns past its own limit.
//
// What bounds it on this card: bytes. Each live K/V row is read once (2 * D
// * itemsize per token and kv head: 1 byte an element for int8 pages)
// against 4 * rows * D flops, below the ~20 flops a byte at which float32
// CUDA cores would be the limit even at 32 rows. With one CTA per (kv head,
// slot) a small batch fills few SMs and each CTA loads, then computes;
// splitting long sequences across CTAs (flash-decoding) and overlapping the
// next chunk's loads with this chunk's math are later work.
#pragma once

#include "common.cuh"

namespace magi {
namespace decode {
// Internal linkage: every kernel library includes this body, and an
// instance with external linkage would be bound across the libraries to
// the first one loaded, whose CUDA runtime does not know the others'
// kernels.
namespace {

constexpr int NT = 128;  // threads per CTA
constexpr int TC = 64;   // tokens per chunk

template <int D, int RMAX>
struct Smem {
  static constexpr int DS = D + 4;     // row stride of the K and V chunks
  static constexpr int SR = RMAX + 4;  // token stride of the scores
  static constexpr size_t bytes =
      sizeof(float) * (RMAX * D + 2 * TC * DS + TC * SR + 4 * RMAX);
};

// TQ: q and out (float or bf16); TP: the pages (TQ, or int8_t with float32
// scales per (page, kv head)).
template <typename TQ, typename TP, int D, int RMAX>
__global__ void __launch_bounds__(NT)
    kernel(const TQ* __restrict__ q, const TP* __restrict__ k_pages,
           const TP* __restrict__ v_pages, const float* __restrict__ k_scales,
           const float* __restrict__ v_scales, const int* __restrict__ table,
           const int* __restrict__ lengths, TQ* __restrict__ out,
           float* __restrict__ lse, int hq, int hk, int ps, int P, int spec_k,
           float scale_log2) {
  static_assert(D <= NT, "one output column per thread");
  constexpr bool QUANT = sizeof(TP) == 1;
  constexpr int DS = Smem<D, RMAX>::DS;
  constexpr int SR = Smem<D, RMAX>::SR;
  constexpr int RPT = RMAX / (NT / TC);  // score rows per thread
  constexpr int QVEC = Vec<TQ>::N;
  constexpr int QCPR = D / QVEC;  // 16-byte chunks per q row
  constexpr int VEC = Vec<TP>::N;
  constexpr int CPR = D / VEC;  // 16-byte chunks per page row
  constexpr int ITER = TC * CPR / NT;
  static_assert(ITER * NT == TC * CPR, "a chunk is a whole number of loads");
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;             // rows x D, pre-scaled
  float* Ks = Qs + RMAX * D;    // TC x DS
  float* Vs = Ks + TC * DS;     // TC x DS
  float* Ss = Vs + TC * DS;     // TC x SR scores, then probabilities
  float* Ms = Ss + TC * SR;     // running max per row (log2 domain)
  float* Ls = Ms + RMAX;        // running sum per row
  float* As = Ls + RMAX;        // this chunk's rescale factor per row
  int* Lim = reinterpret_cast<int*>(As + RMAX);  // live columns per row

  const int g = hq / hk, rows = spec_k * g;
  const int h = blockIdx.x, s = blockIdx.y, tid = threadIdx.x;
  const int len = lengths[s];
  const int* trow = table + (long)s * P;
  const long page_row = (long)hk * D;  // elements between rows of a page

  // CTA row r = t * g + j is q / out row (s * spec_k + t) * hq + h * g + j
  for (int i = tid; i < rows * QCPR; i += NT) {
    const int r = i / QCPR, c = (i % QCPR) * QVEC;
    const long qr = ((long)s * spec_k + r / g) * hq + (long)h * g + r % g;
    Vec<TQ>::to_f32(ldg16(q + qr * D + c), Qs + r * D + c, scale_log2);
  }
  if (tid < RMAX) {
    Ms[tid] = -INFINITY;
    Ls[tid] = 0.f;
    Lim[tid] = len - (spec_k - 1 - tid / g);
  }
  float acc[RMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) acc[r] = 0.f;

  for (int c0 = 0; c0 < len; c0 += TC) {
    const int n = min(TC, len - c0);
    __syncthreads();  // the previous chunk is done with Ks, Vs and Ss
    uint4 rk[ITER], rv[ITER];
    float sk[QUANT ? ITER : 1], sv[QUANT ? ITER : 1];
#pragma unroll
    for (int it = 0; it < ITER; ++it) {
      const int i = tid + it * NT;
      const int j = i / CPR, c = (i % CPR) * VEC;
      if (j < n) {
        const int pos = c0 + j;
        const int page = trow[pos / ps];
        const long base =
            ((long)page * ps + pos % ps) * page_row + (long)h * D + c;
        rk[it] = ldg16(k_pages + base);
        rv[it] = ldg16(v_pages + base);
        if constexpr (QUANT) {
          sk[it] = __ldg(k_scales + (long)page * hk + h);
          sv[it] = __ldg(v_scales + (long)page * hk + h);
        }
      } else {
        rk[it] = rv[it] = make_uint4(0u, 0u, 0u, 0u);
        if constexpr (QUANT) sk[it] = sv[it] = 0.f;
      }
    }
#pragma unroll
    for (int it = 0; it < ITER; ++it) {
      const int i = tid + it * NT;
      const int j = i / CPR, c = (i % CPR) * VEC;
      if constexpr (QUANT) {
        Vec<TP>::to_f32(rk[it], Ks + j * DS + c, sk[it]);
        Vec<TP>::to_f32(rv[it], Vs + j * DS + c, sv[it]);
      } else {
        Vec<TP>::to_f32(rk[it], Ks + j * DS + c, 1.f);
        Vec<TP>::to_f32(rv[it], Vs + j * DS + c, 1.f);
      }
    }
    __syncthreads();

    {  // scores: thread -> token j, rows r = tid / TC + k * NT / TC; each
       // K value is read from shared memory once for all of them
      const int j = tid % TC, r0 = tid / TC;
      float a[RPT];
#pragma unroll
      for (int k = 0; k < RPT; ++k) a[k] = 0.f;
#pragma unroll 4
      for (int dd = 0; dd < D; dd += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(Ks + j * DS + dd);
#pragma unroll
        for (int k = 0; k < RPT; ++k) {
          const int r = r0 + k * (NT / TC);
          if (r < rows) {
            const float4 qv = *reinterpret_cast<const float4*>(Qs + r * D + dd);
            a[k] = fmaf(qv.x, kv.x, a[k]);
            a[k] = fmaf(qv.y, kv.y, a[k]);
            a[k] = fmaf(qv.z, kv.z, a[k]);
            a[k] = fmaf(qv.w, kv.w, a[k]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const int r = r0 + k * (NT / TC);
        if (r < rows) Ss[j * SR + r] = c0 + j < Lim[r] ? a[k] : -INFINITY;
      }
    }
    __syncthreads();

    {  // online softmax: one warp per row
      const int warp = tid >> 5, lane = tid & 31;
      for (int r = warp; r < rows; r += NT / 32) {
        const float a = Ss[lane * SR + r], b = Ss[(lane + 32) * SR + r];
        float mx = fmaxf(a, b);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_old = Ms[r];
        const float m_new = fmaxf(m_old, mx);
        // -inf only while a row has seen no live column: then p and the
        // rescale are 0 and the row stays empty
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float pa = exp2f(a - m_use), pb = exp2f(b - m_use);
        Ss[lane * SR + r] = pa;
        Ss[(lane + 32) * SR + r] = pb;
        float sum = pa + pb;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) {
          const float alpha = exp2f(m_old - m_use);
          As[r] = alpha;
          Ls[r] = Ls[r] * alpha + sum;
          Ms[r] = m_new;
        }
      }
    }
    __syncthreads();

    if (tid < D) {
#pragma unroll
      for (int r = 0; r < RMAX; ++r)
        if (r < rows) acc[r] *= As[r];
      for (int j = 0; j < n; ++j) {
        const float vv = Vs[j * DS + tid];
#pragma unroll
        for (int r = 0; r < RMAX; r += 4)
          if (r < rows) {  // token j's probabilities of rows r..r+3
            const float4 p = *reinterpret_cast<const float4*>(Ss + j * SR + r);
            acc[r] = fmaf(p.x, vv, acc[r]);
            acc[r + 1] = fmaf(p.y, vv, acc[r + 1]);
            acc[r + 2] = fmaf(p.z, vv, acc[r + 2]);
            acc[r + 3] = fmaf(p.w, vv, acc[r + 3]);
          }
      }
    }
  }
  __syncthreads();

  if (tid < D) {
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
      if (r < rows) {
        const long orow = ((long)s * spec_k + r / g) * hq + (long)h * g + r % g;
        store_out(out + orow * D + tid, Lim[r] > 0 ? acc[r] / Ls[r] : 0.f);
      }
  }
  if (tid < rows) {
    const long orow =
        ((long)s * spec_k + tid / g) * hq + (long)h * g + tid % g;
    lse[orow] = Lim[tid] > 0 ? (Ms[tid] + log2f(Ls[tid])) * LN2 : -INFINITY;
  }
}

// One launch over S slots x hk kv heads; 0 or the CUDA error.
template <typename TQ, typename TP, int D, int RMAX>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const float* k_scales, const float* v_scales, const int* table,
           const int* lengths, void* out, float* lse, int S, int hq, int hk,
           int ps, int P, int spec_k, float softmax_scale, void* stream) {
  static bool smem_ok = false;
  const size_t smem = Smem<D, RMAX>::bytes;
  cudaError_t e = allow_smem(kernel<TQ, TP, D, RMAX>, smem, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(hk, S);
  kernel<TQ, TP, D, RMAX><<<grid, NT, smem, (cudaStream_t)stream>>>(
      static_cast<const TQ*>(q), static_cast<const TP*>(k_pages),
      static_cast<const TP*>(v_pages), k_scales, v_scales, table, lengths,
      static_cast<TQ*>(out), lse, hq, hk, ps, P, spec_k,
      softmax_scale * LOG2E);
  return (int)cudaGetLastError();
}

// head_dim 64 or 128; rows = spec_k * hq / hk at most RMAX.
template <typename TQ, typename TP, int RMAX>
int dispatch(int d, const void* q, const void* k_pages, const void* v_pages,
             const float* k_scales, const float* v_scales, const int* table,
             const int* lengths, void* out, float* lse, int S, int hq, int hk,
             int ps, int P, int spec_k, float softmax_scale, void* stream) {
  if (hk <= 0 || hq % hk != 0 || spec_k < 1 || spec_k * (hq / hk) > RMAX)
    return (int)cudaErrorInvalidValue;
  switch (d) {
    case 64:
      return launch<TQ, TP, 64, RMAX>(q, k_pages, v_pages, k_scales, v_scales,
                                      table, lengths, out, lse, S, hq, hk, ps,
                                      P, spec_k, softmax_scale, stream);
    case 128:
      return launch<TQ, TP, 128, RMAX>(q, k_pages, v_pages, k_scales,
                                       v_scales, table, lengths, out, lse, S,
                                       hq, hk, ps, P, spec_k, softmax_scale,
                                       stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace decode
}  // namespace magi
