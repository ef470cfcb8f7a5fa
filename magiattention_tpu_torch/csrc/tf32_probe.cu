// Probe of 3xTF32 on wgmma, for chip_smoke.py's tf32_probe phase (not a
// kernel of any path): how much the tensor cores' float32 accumulation of
// tf32 products loses against float32 FMA, which fixed the accumulator
// layout of csrc/ffa_fwd_tf32.cuh.
//
// probe_s: S = Q K^T of one 64-row q tile and one 32-key chunk (q [sq, hq,
// D], k [sk, hk, D], D = 128) by wgmma m64n32k8 from split hi / lo tiles,
// s [hq, sq, sk]. probe_pv: O = P V of one 64-row tile over all sk keys in
// 32-key chunks (p [hq, sq, sk], v [sk, hk, D]), P from registers in the
// accumulator layout, V transposed in kperm order, o [hq, sq, D]. Modes:
// 1, the hi hi products alone (one TF32 product); 3, the three products of
// 3xTF32 into one accumulator (P V: one accumulator over all chunks); 4,
// the body's layout (S: small and hi hi terms in two accumulators; P V: a
// fresh accumulator per chunk, added by float32 FMA).
#include "tc.cuh"

namespace {

using namespace magi::tc;

constexpr int D = 128;

// 64 (or ROWS) rows of D floats -> hi/lo swizzled tiles
template <int ROWS>
__device__ void split_rows(uint8_t* hi, uint8_t* lo, const float* src,
                           long rs, int t) {
  for (int i = t; i < ROWS * D / 4; i += 128) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const float4 x = *reinterpret_cast<const float4*>(src + r * rs + c);
    float4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<float4*>(hi + tile_offset32<ROWS>(r, c)) = h;
    *reinterpret_cast<float4*>(lo + tile_offset32<ROWS>(r, c)) = l;
  }
}

__global__ void __launch_bounds__(128)
    probe_s(const float* q, const float* k, float* s, int sq, int sk, int hq,
            int hk, int mode) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qh = smem;
  uint8_t* Ql = Qh + 64 * D * 4;
  uint8_t* Kh = Ql + 64 * D * 4;
  uint8_t* Kl = Kh + 32 * D * 4;
  const int t = threadIdx.x, qt = blockIdx.x, kc = blockIdx.y, h = blockIdx.z;
  const int hkv = h / (hq / hk);
  split_rows<64>(Qh, Ql, q + ((long)qt * 64 * hq + h) * D, (long)hq * D, t);
  split_rows<32>(Kh, Kl, k + ((long)kc * 32 * hk + hkv) * D, (long)hk * D, t);
  fence_async_smem();
  __syncthreads();
  float d[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) d[i] = 0.f;
  fence_regs(d);
  wgmma_fence();
  const uint32_t qh = smem_u32(Qh), ql = smem_u32(Ql), kh = smem_u32(Kh),
                 kl = smem_u32(Kl);
  float e[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) e[i] = 0.f;
  fence_regs(e);
  if (mode == 4) {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      wgmma_tf32_ss_n32(e, desc_k32<64>(ql, kk), desc_k32<32>(kh, kk));
      wgmma_tf32_ss_n32(e, desc_k32<64>(qh, kk), desc_k32<32>(kl, kk));
    }
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      wgmma_tf32_ss_n32(d, desc_k32<64>(qh, kk), desc_k32<32>(kh, kk));
  } else {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    if (mode == 3) {
      wgmma_tf32_ss_n32(d, desc_k32<64>(ql, kk), desc_k32<32>(kh, kk));
      wgmma_tf32_ss_n32(d, desc_k32<64>(qh, kk), desc_k32<32>(kl, kk));
    }
    wgmma_tf32_ss_n32(d, desc_k32<64>(qh, kk), desc_k32<32>(kh, kk));
  }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  fence_regs(e);
#pragma unroll
  for (int i = 0; i < 16; ++i) d[i] += e[i];
  const int warp = t >> 5, lane = t & 31;
  const int r0 = warp * 16 + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int row = qt * 64 + r0 + ((i >> 1) & 1) * 8;
    const int col = kc * 32 + (i >> 2) * 8 + c0 + (i & 1);
    s[((long)h * sq + row) * sk + col] = d[i];
  }
}

// O[64 x D] = sum over 32-key chunks of P V; p [hq, sq, sk], v [sk, hk, D]
__global__ void __launch_bounds__(128)
    probe_pv(const float* p, const float* v, float* o, int sq, int sk, int hq,
             int hk, int mode) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Vh = smem;            // D rows x 32 keys
  uint8_t* Vl = Vh + D * 32 * 4;
  const int t = threadIdx.x, qt = blockIdx.x, h = blockIdx.y;
  const int hkv = h / (hq / hk);
  const int warp = t >> 5, lane = t & 31;
  const int r0 = warp * 16 + (lane >> 2), c0 = 2 * (lane & 3);
  float acc[D / 2], tot[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = tot[i] = 0.f;
  for (int k0 = 0; k0 < sk; k0 += 32) {
    __syncthreads();
    // thread t: head-dim row n = t, its 32 keys in 4 groups of 8
    const int n = t;
#pragma unroll
    for (int grp = 0; grp < 4; ++grp) {
      float hv[8], lv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float x = v[((long)(k0 + grp * 8 + j) * hk + hkv) * D + n];
        split_tf32(x, hv[kpos(j)], lv[kpos(j)]);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = grp * 8 + half * 4;
        *reinterpret_cast<float4*>(Vh + tile_offset32<D>(n, c)) =
            make_float4(hv[half * 4], hv[half * 4 + 1], hv[half * 4 + 2], hv[half * 4 + 3]);
        *reinterpret_cast<float4*>(Vl + tile_offset32<D>(n, c)) =
            make_float4(lv[half * 4], lv[half * 4 + 1], lv[half * 4 + 2], lv[half * 4 + 3]);
      }
    }
    fence_async_smem();
    __syncthreads();
    float pd[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int row = qt * 64 + r0 + ((i >> 1) & 1) * 8;
      const int col = k0 + (i >> 2) * 8 + c0 + (i & 1);
      pd[i] = p[((long)h * sq + row) * sk + col];
    }
    uint32_t ph[4][4], pl[4][4];
    to_a_frags_tf32(ph, pl, pd);
    if (mode == 1) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) pl[kk][e] = 0u;
    }
    fence_regs(ph);
    fence_regs(pl);
    fence_regs(acc);
    wgmma_fence();
    const uint32_t vh = smem_u32(Vh), vl = smem_u32(Vl);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_tf32_rs<D>(acc, pl[kk], desc_k32<D>(vh, kk));
      wgmma_tf32_rs<D>(acc, ph[kk], desc_k32<D>(vl, kk));
      wgmma_tf32_rs<D>(acc, ph[kk], desc_k32<D>(vh, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(ph);
    fence_regs(pl);
    if (mode == 4) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        tot[i] += acc[i];
        acc[i] = 0.f;
      }
    }
  }
  if (mode == 4) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = tot[i];
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    const int row = qt * 64 + r0 + ((i >> 1) & 1) * 8;
    const int col = (i >> 2) * 8 + c0 + (i & 1);
    o[((long)h * sq + row) * D + col] = acc[i];
  }
}

}  // namespace

extern "C" int tf32_probe_s(const float* q, const float* k, float* s, int sq, int sk,
                     int hq, int hk, int mode) {
  const int smem = (64 * 2 + 32 * 2) * D * 4 + 1024;
  cudaFuncSetAttribute(probe_s, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  probe_s<<<dim3(sq / 64, sk / 32, hq), 128, smem>>>(q, k, s, sq, sk, hq, hk, mode);
  return (int)cudaGetLastError();
}

extern "C" int tf32_probe_pv(const float* p, const float* v, float* o, int sq, int sk,
                      int hq, int hk, int mode) {
  const int smem = 2 * D * 32 * 4 + 1024;
  cudaFuncSetAttribute(probe_pv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  probe_pv<<<dim3(sq / 64, hq), 128, smem>>>(p, v, o, sq, sk, hq, hk, mode);
  return (int)cudaGetLastError();
}
