// FFA forward over the host-built q-major work list, for Hopper (sm_90a).
//
// Replaces: magiattention_tpu/kernels/ffa.py:_fwd_kernel (wrapper
// _ffa_fwd_pallas, pallas_call at ffa.py:462).
//
// What it computes: for every q head h and q row i, softmax attention over
// the k rows j that some slice covers (slice rectangle intersected with the
// band d_lo <= j - i <= d_hi); out = P V, lse = log(sum exp(s)) in natural
// log. A row no slice covers gives out 0 and lse -inf.
//
// Design. The TPU kernel walks a sequential grid (hq, W) and carries a q
// tile's m/l/acc in VMEM scratch from its IS_FIRST item to its IS_LAST item.
// Blocks on a GPU run in no order, so here ONE CTA owns one (q tile, q head)
// and loops over that q tile's run of work items itself (run_ptr is the CSR
// offset array over the runs, kernels/ffa_plan.py). The running max, sum and
// output accumulator stay in registers for the whole run, the output is
// written once, and no atomics are needed. CTAs take q tiles from the last
// to the first, so under a causal mask the longest runs start first.
//
// Per work item: the 64-row k tile goes to shared memory, S = Q K^T is
// computed with float32 FMAs (each of 256 threads owns a 4 x 4 block of S,
// rows ty + 16 i, cols tx + 16 j), masked unless the item is IS_FULL, the
// online softmax runs in the exp2 domain (scale * log2(e) applied to the
// float32 scores, never to a rounded copy of q), P goes to shared memory,
// the v tile replaces the k tile, and acc += P V (each thread owns 4 rows x
// D/16 columns of the output).
//
// What bounds it on this card: operations. Work is 4 * D flops per live
// (row, col) pair and head. It runs on the CUDA cores in float32 (67
// TFLOP/s peak on an H100 SXM), for bf16 inputs too; tensor cores (wgmma,
// 989 TFLOP/s in bf16) and TMA loads overlapped with compute are later
// work. The float32 path must stay on FMA, never TF32, to hold the serving
// replay tolerance. Shared memory per CTA is 86 KB (Q and one K-or-V tile,
// stride D + 4 so the 16-byte reads of 8 neighbouring threads hit distinct
// banks, and the 64 x 80 P tile), so two CTAs share an SM.
#include "common.cuh"

namespace {

using magi::LN2;
using magi::LOG2E;
using magi::Vec;

using magi::META_DIM;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;

template <int D>
struct FwdSmem {
  static constexpr int DS = D + 4;      // row stride of the Q and K/V tiles
  static constexpr int PSTR = BK + 16;  // row stride of the P tile
  static constexpr size_t bytes =
      sizeof(float) * (BQ * DS + BK * DS + BQ * PSTR);
};

template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long row_stride, int n_valid) {
  magi::load_tile<T, D, NT>(dst, src, row_stride, n_valid);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, 2)
    ffa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out,
                   float* __restrict__ lse, const int* __restrict__ work_kt,
                   const int* __restrict__ meta,
                   const int* __restrict__ run_ptr, int sq, int sk, int hq,
                   int hk, int num_q_tiles, float scale, float softcap) {
  constexpr int DS = FwdSmem<D>::DS;
  constexpr int PSTR = FwdSmem<D>::PSTR;
  constexpr int CG = D / 64;  // float4 column groups a thread owns in O
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* KVs = Qs + BQ * DS;
  float* Ps = KVs + BK * DS;

  const int qt = num_q_tiles - 1 - (int)blockIdx.x;
  const int h = blockIdx.y;
  const int hkv = h / (hq / hk);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = qt * BQ;
  const long q_rs = (long)hq * D, kv_rs = (long)hk * D;

  load_tile<T, D>(Qs, q + ((long)q0 * hq + h) * D, q_rs, min(BQ, sq - q0));

  float m[4], l[4], acc[4][4 * CG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * CG; ++c) acc[i][c] = 0.f;
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

    __syncthreads();  // the previous item's P V is done with KVs and Ps
    load_tile<T, D>(KVs, k + ((long)k0 * hk + hkv) * D, kv_rs, k_valid);
    __syncthreads();

    float s[4][4];
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
        kv[j] = *reinterpret_cast<const float4*>(KVs + (tx + 16 * j) * DS + dd);
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

    // online softmax; a row's 64 columns live in the 16 lanes sharing ty
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[i] - m_use);  // 0 while the row is empty
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
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * CG; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(ty + 16 * i) * PSTR + tx + 16 * j] = s[i][j];
    }
    __syncthreads();  // S is done with the k tile; P is visible
    load_tile<T, D>(KVs, v + ((long)k0 * hk + hkv) * D, kv_rs, k_valid);
    __syncthreads();

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
              KVs + (kk + e) * DS + cg * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = e == 0 ? pv[i].x
                            : e == 1 ? pv[i].y
                            : e == 2 ? pv[i].z
                                     : pv[i].w;
            acc[i][cg * 4 + 0] = fmaf(p, vv.x, acc[i][cg * 4 + 0]);
            acc[i][cg * 4 + 1] = fmaf(p, vv.y, acc[i][cg * 4 + 1]);
            acc[i][cg * 4 + 2] = fmaf(p, vv.z, acc[i][cg * 4 + 2]);
            acc[i][cg * 4 + 3] = fmaf(p, vv.w, acc[i][cg * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const bool empty = l[i] == 0.f;  // no slice covers this row
    T* o = out + ((long)row * hq + h) * D;
#pragma unroll
    for (int cg = 0; cg < CG; ++cg)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        magi::store_out(o + cg * 64 + tx * 4 + e,
                        empty ? 0.f : acc[i][cg * 4 + e] / l[i]);
    if (tx == 0)
      lse[(long)row * hq + h] =
          empty ? -INFINITY : (m[i] + log2f(l[i])) * LN2;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           const int* work_kt, const int* meta, const int* run_ptr, int sq,
           int sk, int hq, int hk, int num_q_tiles, float scale,
           float softcap, void* stream) {
  static bool smem_ok = false;
  const size_t smem = FwdSmem<D>::bytes;
  cudaError_t e = magi::allow_smem(ffa_fwd_kernel<T, D>, smem, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(num_q_tiles, hq);
  ffa_fwd_kernel<T, D><<<grid, NT, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, work_kt, meta,
      run_ptr, sq, sk, hq, hk, num_q_tiles, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, void* out,
             float* lse, const int* work_kt, const int* meta,
             const int* run_ptr, int sq, int sk, int hq, int hk,
             int num_q_tiles, float scale, float softcap, void* stream) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, k, v, out, lse, work_kt, meta, run_ptr, sq, sk,
                           hq, hk, num_q_tiles, scale, softcap, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, work_kt, meta, run_ptr, sq,
                            sk, hq, hk, num_q_tiles, scale, softcap, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [sq, hq, d], k/v [sk, hk, d] and out [sq, hq, d] are contiguous rows of
// one dtype; lse [sq, hq] float32. work_kt (W,), meta (W, 15) and run_ptr
// (num_q_tiles + 1,) are the plan's int32 arrays on the device.
extern "C" int ffa_fwd_f32(const void* q, const void* k, const void* v,
                           void* out, float* lse, const int* work_kt,
                           const int* meta, const int* run_ptr, int sq,
                           int sk, int hq, int hk, int d, int num_q_tiles,
                           float scale, float softcap, void* stream) {
  return dispatch<float>(d, q, k, v, out, lse, work_kt, meta, run_ptr, sq, sk,
                         hq, hk, num_q_tiles, scale, softcap, stream);
}

extern "C" int ffa_fwd_bf16(const void* q, const void* k, const void* v,
                            void* out, float* lse, const int* work_kt,
                            const int* meta, const int* run_ptr, int sq,
                            int sk, int hq, int hk, int d, int num_q_tiles,
                            float scale, float softcap, void* stream) {
  return dispatch<__nv_bfloat16>(d, q, k, v, out, lse, work_kt, meta, run_ptr,
                                 sq, sk, hq, hk, num_q_tiles, scale, softcap,
                                 stream);
}
