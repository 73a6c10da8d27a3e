// Shared by the bf16 fused GCL backward sources (`gcl_bwd_fused_bf16_tc.cu`
// at S = 32, `gcl_bwd_fused_grid_bf16_tc.cu`, `gcl_bwd_fused_long_bf16_tc.cu`):
// the swizzled layouts of their shared-memory tiles, the messages rebuilt in
// bf16x2 arithmetic, and the dW product's `mma.sync` step.
// GCL_DW_NO_MMA, defined before the include, leaves the dW product's MMAs
// out (its fragment loads kept): `ops/kernels/ablate_gcl_bwd_fused.py`'s
// variant of that name, which computes wrong gradients.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

#include "gcl_common.cuh"
#include "mma_bf16.cuh"

namespace gcl {

constexpr int TILE_K = 32;   // bf16 a row of the stage and A tiles (s_off)
constexpr int TILE_G = 64;   // bf16 a row of the dW kernels' g tiles (g_off)

// Element offset of 8-element chunk ch (of 4) of row r in a tile of TILE_K
// features a row: stored at chunk ch ^ ((r / 2) % 4), so the 8 rows of an
// ldmatrix (64 bytes apart) touch 8 distinct 16-byte bank groups.
__device__ __forceinline__ int s_off(int r, int ch) {
  return r * TILE_K + ((ch ^ ((r >> 1) & 3)) << 3);
}

// Element offset of 8-element chunk ch (of 8) of row r in a g tile of
// TILE_G features a row: stored at chunk ch ^ (r % 8), so the 8 rows of an
// ldmatrix (128 bytes apart) touch 8 distinct 16-byte bank groups.
__device__ __forceinline__ int g_off(int r, int ch) {
  return r * TILE_G + ((ch ^ (r & 7)) << 3);
}

// Four bf16 values (columns q..q+3) in two pairs. The rebuild computes in
// bf16x2 arithmetic, correctly rounded: the same value as the fp32 op
// rounded to bf16 that the Pallas body does, since a product of two bf16
// values is exact in fp32, and a sum is too unless one term is below 2^-16
// of the other, far from a bf16 tie.
struct H4 {
  __nv_bfloat162 lo, hi;
};

__device__ __forceinline__ H4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return {*reinterpret_cast<const __nv_bfloat162*>(&u.x), *reinterpret_cast<const __nv_bfloat162*>(&u.y)};
}

__device__ __forceinline__ void st4(__nv_bfloat16* p, H4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&v.lo),
                                            *reinterpret_cast<const uint32_t*>(&v.hi));
}

__device__ __forceinline__ H4 mul(H4 a, __nv_bfloat162 s) { return {__hmul2(a.lo, s), __hmul2(a.hi, s)}; }
__device__ __forceinline__ H4 add(H4 a, H4 b) { return {__hadd2(a.lo, b.lo), __hadd2(a.hi, b.hi)}; }
__device__ __forceinline__ H4 sub(H4 a, H4 b) { return {__hsub2(a.lo, b.lo), __hsub2(a.hi, b.hi)}; }

// relu(rnd(a * b)) * s: a message through a relation, s its 0/1 validity
__device__ __forceinline__ H4 msg(H4 a, H4 b, __nv_bfloat162 s) {
  const __nv_bfloat162 z = __float2bfloat162_rn(0.f);
  return {__hmul2(__hmax2(__hmul2(a.lo, b.lo), z), s),
          __hmul2(__hmax2(__hmul2(a.hi, b.hi), z), s)};
}

// rnd(v[0] + v[1] + v[2] + v[3]), the sums in fp32 in this order
__device__ __forceinline__ H4 col_sum(const H4 (&v)[T]) {
  float2 lo = __bfloat1622float2(v[0].lo), hi = __bfloat1622float2(v[0].hi);
#pragma unroll
  for (int t = 1; t < T; ++t) {
    const float2 l = __bfloat1622float2(v[t].lo), h = __bfloat1622float2(v[t].hi);
    lo.x += l.x; lo.y += l.y; hi.x += h.x; hi.y += h.y;
  }
  return {__floats2bfloat162_rn(lo.x, lo.y), __floats2bfloat162_rn(hi.x, hi.y)};
}

// acc[mt][nt] (rows 16 mt.., columns 8 nt.. of the warp's 32 x 32) += the
// 16-row k-step of A tile a (k-major, s_off) at rows k0.. times b, the
// warp's B fragments of that k-step: b[np] holds n8 tiles 2 np, 2 np + 1.
__device__ __forceinline__ void dw_mma(float (&acc)[2][4][4], const __nv_bfloat16* a_tile,
                                       int k0, const uint32_t (&b)[2][4],
                                       int lane) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    // matrices: (k 0-7, c 0-7), (k 0-7, c 8-15), (k 8-15, c 0-7), (k 8-15,
    // c 8-15), transposed: a0..a3 of the row-major 16 x 16 A
    uint32_t a[4];
    tc::ldsm_x4_t(a, a_tile + s_off(k0 + (lane & 7) + ((lane >> 4) << 3),
                                    2 * mt + ((lane >> 3) & 1)));
#ifndef GCL_DW_NO_MMA
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      tc::mma_bf16(acc[mt][nt], a, b[nt >> 1][2 * (nt & 1)],
                   b[nt >> 1][2 * (nt & 1) + 1]);
#endif
  }
}

}  // namespace gcl
