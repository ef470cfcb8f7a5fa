// Paged decode attention for Hopper (sm_90a): one query row per slot,
// straight from the paged KV cache.
//
// Replaces: magiattention_tpu/kernels/paged_decode.py:_paged_decode_kernel
// (wrapper _paged_decode_pallas, pallas_call at paged_decode.py:192).
//
// What it computes: for slot s and q head h, softmax attention of q[s, h]
// over k/v rows [0, lengths[s]) of that slot, where row r lives in page
// page_table[s, r / ps] at row r % ps. out 0 and lse -inf for an empty slot
// (length 0); lse in natural log.
//
// Design. One CTA per (kv head, slot). The g = hq / hk query rows of that
// kv head share every K/V read, as the TPU kernel's (g, d) q tile does. The
// CTA walks the slot's page table in chunks of 64 tokens (four 16-row
// pages: a page alone is smaller than a useful tile), loads the chunk's
// K and V rows into shared memory as float32 (all loads of a chunk are
// issued before the first is used), computes the g x 64 scores, updates
// the running max and sum per query row in the exp2 domain (q scaled by
// softmax_scale * log2(e) in float32 inside the kernel), and accumulates
// P V with one output column per thread. Lengths are read on the device,
// so one launch serves every tick. The TPU kernel visits every table
// entry and clamps -1 to page 0; this one stops at ceil(length / ps) pages
// and never reads a dead page or table entry.
//
// What bounds it on this card: bytes. Each live K/V row is read once
// (2 * D * itemsize per token and kv head) against 4 * g * D flops, far
// below the ~20 flops a byte at which float32 CUDA cores would be the limit.
// With one CTA per (kv head, slot) a small batch fills few SMs (8 x 8 = 64
// CTAs of 132 SMs at the serving shape) and each CTA loads, then computes;
// splitting long sequences across CTAs (flash-decoding) and overlapping the
// next chunk's loads with this chunk's math are later work.
#include "common.cuh"

namespace {

using magi::LN2;
using magi::LOG2E;
using magi::Vec;

constexpr int NT = 128;  // threads per CTA
constexpr int TC = 64;   // tokens per chunk
constexpr int GMAX = 8;  // largest query group hq / hk

template <int D>
struct DecSmem {
  static constexpr int DS = D + 4;  // row stride of the K and V chunks
  static constexpr size_t bytes =
      sizeof(float) * (GMAX * D + 2 * TC * DS + GMAX * TC + 3 * GMAX);
};

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                        const T* __restrict__ v_pages,
                        const int* __restrict__ table,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        float* __restrict__ lse, int hq, int hk, int ps, int P,
                        float scale_log2) {
  static_assert(D <= NT, "one output column per thread");
  constexpr int DS = DecSmem<D>::DS;
  constexpr int VEC = Vec<T>::N;
  constexpr int CPR = D / VEC;  // 16-byte chunks per row
  constexpr int ITER = TC * CPR / NT;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;             // g x D, pre-scaled
  float* Ks = Qs + GMAX * D;    // TC x DS
  float* Vs = Ks + TC * DS;     // TC x DS
  float* Ss = Vs + TC * DS;     // g x TC scores, then probabilities
  float* Ms = Ss + GMAX * TC;   // running max per query row (log2 domain)
  float* Ls = Ms + GMAX;        // running sum per query row
  float* As = Ls + GMAX;        // this chunk's rescale factor per row

  const int g = hq / hk;
  const int h = blockIdx.x, s = blockIdx.y, tid = threadIdx.x;
  const int len = lengths[s];
  const int* trow = table + (long)s * P;
  const long page_row = (long)hk * D;  // elements between rows of a page
  const long q_row0 = (long)s * hq + (long)h * g;

  for (int i = tid; i < g * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * VEC;
    Vec<T>::to_f32(magi::ldg16(q + (q_row0 + r) * D + c), Qs + r * D + c,
                   scale_log2);
  }
  if (tid < GMAX) {
    Ms[tid] = -INFINITY;
    Ls[tid] = 0.f;
  }
  float acc[GMAX];
#pragma unroll
  for (int r = 0; r < GMAX; ++r) acc[r] = 0.f;

  for (int c0 = 0; c0 < len; c0 += TC) {
    const int n = min(TC, len - c0);
    __syncthreads();  // the previous chunk is done with Ks, Vs and Ss
    uint4 rk[ITER], rv[ITER];
#pragma unroll
    for (int it = 0; it < ITER; ++it) {
      const int i = tid + it * NT;
      const int j = i / CPR, c = (i % CPR) * VEC;
      if (j < n) {
        const int pos = c0 + j;
        const long base =
            ((long)trow[pos / ps] * ps + pos % ps) * page_row + (long)h * D + c;
        rk[it] = magi::ldg16(k_pages + base);
        rv[it] = magi::ldg16(v_pages + base);
      } else {
        rk[it] = rv[it] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int it = 0; it < ITER; ++it) {
      const int i = tid + it * NT;
      const int j = i / CPR, c = (i % CPR) * VEC;
      Vec<T>::to_f32(rk[it], Ks + j * DS + c, 1.f);
      Vec<T>::to_f32(rv[it], Vs + j * DS + c, 1.f);
    }
    __syncthreads();

    {  // scores: thread -> token j, query rows r = tid / TC, + NT / TC, ...
      const int j = tid % TC;
      for (int r = tid / TC; r < g; r += NT / TC) {
        float a = 0.f;
#pragma unroll 8
        for (int dd = 0; dd < D; dd += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(Ks + j * DS + dd);
          const float4 qv = *reinterpret_cast<const float4*>(Qs + r * D + dd);
          a = fmaf(qv.x, kv.x, a);
          a = fmaf(qv.y, kv.y, a);
          a = fmaf(qv.z, kv.z, a);
          a = fmaf(qv.w, kv.w, a);
        }
        Ss[r * TC + j] = j < n ? a : -INFINITY;
      }
    }
    __syncthreads();

    {  // online softmax: one warp per query row
      const int warp = tid >> 5, lane = tid & 31;
      for (int r = warp; r < g; r += NT / 32) {
        const float a = Ss[r * TC + lane], b = Ss[r * TC + lane + 32];
        float mx = fmaxf(a, b);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_old = Ms[r];
        const float m_new = fmaxf(m_old, mx);  // finite: the chunk has a live row
        const float pa = exp2f(a - m_new), pb = exp2f(b - m_new);
        Ss[r * TC + lane] = pa;
        Ss[r * TC + lane + 32] = pb;
        float sum = pa + pb;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) {
          const float alpha = exp2f(m_old - m_new);
          As[r] = alpha;
          Ls[r] = Ls[r] * alpha + sum;
          Ms[r] = m_new;
        }
      }
    }
    __syncthreads();

    if (tid < D) {
#pragma unroll
      for (int r = 0; r < GMAX; ++r)
        if (r < g) acc[r] *= As[r];
      for (int j = 0; j < n; ++j) {
        const float vv = Vs[j * DS + tid];
#pragma unroll
        for (int r = 0; r < GMAX; ++r)
          if (r < g) acc[r] = fmaf(Ss[r * TC + j], vv, acc[r]);
      }
    }
  }
  __syncthreads();

  if (tid < D) {
#pragma unroll
    for (int r = 0; r < GMAX; ++r)
      if (r < g)
        magi::store_out(out + (q_row0 + r) * D + tid,
                        len > 0 ? acc[r] / Ls[r] : 0.f);
  }
  if (tid < g)
    lse[q_row0 + tid] =
        len > 0 ? (Ms[tid] + log2f(Ls[tid])) * LN2 : -INFINITY;
}

template <typename T, int D>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* table, const int* lengths, void* out, float* lse,
           int S, int hq, int hk, int ps, int P, float softmax_scale,
           void* stream) {
  static bool smem_ok = false;
  const size_t smem = DecSmem<D>::bytes;
  cudaError_t e = magi::allow_smem(paged_decode_kernel<T, D>, smem, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(hk, S);
  paged_decode_kernel<T, D><<<grid, NT, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), table, lengths, static_cast<T*>(out),
      lse, hq, hk, ps, P, softmax_scale * LOG2E);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int d, const void* q, const void* k_pages, const void* v_pages,
             const int* table, const int* lengths, void* out, float* lse,
             int S, int hq, int hk, int ps, int P, float softmax_scale,
             void* stream) {
  if (hq % hk != 0 || hq / hk > GMAX) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 64:
      return launch<T, 64>(q, k_pages, v_pages, table, lengths, out, lse, S,
                           hq, hk, ps, P, softmax_scale, stream);
    case 128:
      return launch<T, 128>(q, k_pages, v_pages, table, lengths, out, lse, S,
                            hq, hk, ps, P, softmax_scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [S, hq, d] and out [S, hq, d] contiguous; k/v pages [N, ps, hk, d]
// contiguous, same dtype as q; table [S, P] and lengths [S] int32 on the
// device; lse [S, hq] float32.
extern "C" int paged_decode_f32(const void* q, const void* k_pages,
                                const void* v_pages, const int* table,
                                const int* lengths, void* out, float* lse,
                                int S, int hq, int hk, int d, int ps, int P,
                                float softmax_scale, void* stream) {
  return dispatch<float>(d, q, k_pages, v_pages, table, lengths, out, lse, S,
                         hq, hk, ps, P, softmax_scale, stream);
}

extern "C" int paged_decode_bf16(const void* q, const void* k_pages,
                                 const void* v_pages, const int* table,
                                 const int* lengths, void* out, float* lse,
                                 int S, int hq, int hk, int d, int ps, int P,
                                 float softmax_scale, void* stream) {
  return dispatch<__nv_bfloat16>(d, q, k_pages, v_pages, table, lengths, out,
                                 lse, S, hq, hk, ps, P, softmax_scale, stream);
}
