// The gather half of the long-bar GCL data backward (bars of 4 x S cells,
// S > 48), shared by the two sources whose product kernels write its
// inputs: `gcl_bwd_data_long.cu` (the split data backward, fp32 and bf16,
// its product in FFMA) and `gcl_bwd_fused_long_bf16_tc.cu` (the bf16 fused
// backward, its dH product on the tensor cores).
//
// A cell's dx needs the upstream of the cells that read it as their
// source (the next active cell of its track, its track's cell in the next
// active column), which may lie anywhere in the bar. So the product kernel
// writes the upstream into a scratch of UP_PLANES fp32 planes a bar, (nbar,
// UP_PLANES, N, d), and dH_root m into dr (nbar, N, d), fp32:
//   dmsg = dH_track m r_tr (read by the track relations),
//   dz   = colsum(dnx) - dnx, dnx = dH_next m r_nx (the next relation),
//   dy0  = colsum(dcol) - dcol + dH_self m single, dcol = dH_onset m r_on
//          (read by the cell itself);
// and this kernel finishes dx, dgate and dbias from them. A CTA owns one bar
// and GATHER_THREADS features, a warp 32 (a feature a lane); it inverts the
// bar's relations at the statics' decode (no atomics) and walks the cells
// in order, adding to dH_root m the shares gathered from the scratch (then
// writing dx), and to this bar's row of dgate partials in `part` (each
// element owned by one thread) their dgate shares; dbias by the same walk.
// `gather_long` sums the rows of `part` in bar order (`gcl::sum_rows`): no
// float atomics, bitwise repeatable. Values are rounded to E where
// `_bwd_data_kernel` casts (`rnd`, the identity for fp32).
#pragma once
#include <cuda_runtime.h>

#include <type_traits>

#include "gcl_common.cuh"

namespace gcl {

constexpr int UP_PLANES = 3;         // scratch planes: dmsg, dz, dy0
constexpr int GATHER_THREADS = 128;  // 4 warps x 32 features

// dx = dH_root m (dr; in fp32 dx itself, updated in place) + the shares the
// bar's cells take through the relations and the self term, and this bar's
// row of dgate / dbias partials, part[bar] = [dgate (S, d) | dbias (n)]
// (zero before); g rows n wide, the CTAs of features f < n also sum dbias.
template <typename E>
__global__ void __launch_bounds__(GATHER_THREADS)
gcl_bwd_gather_long_kernel(const E* __restrict__ x,
                           const E* __restrict__ g,
                           const int* __restrict__ aux,
                           const E* __restrict__ gates,
                           const float* __restrict__ up,
                           const float* __restrict__ dr,
                           E* __restrict__ dx, float* __restrict__ part,
                           int S, int d, int n) {
  using R = Elem<E>;
  constexpr bool kInPlace = std::is_same<E, float>::value;
  // src[r][j] = i | dist << 16 for the cell i that reads cell j through
  // relation r (0 previous, 1 next in the track, 2 previous column) and
  // whose share is not 0, or -1; m[j] the mask
  extern __shared__ int gsm[];
  const int N = T * S;
  int* src = gsm;
  float* m = reinterpret_cast<float*>(gsm + 3 * N);
  const int bar = blockIdx.x, tid = threadIdx.x;
  const int* a = aux + (size_t)bar * N_AUX * N;
  for (int i = tid; i < 3 * N; i += GATHER_THREADS) src[i] = -1;
  __syncthreads();
  for (int i = tid; i < N; i += GATHER_THREADS) {
    const CellStatics c = cell_statics_grid(a, i, N, S);
    m[i] = c.m;
    if (c.m > 0.f && c.okp > 0.f) src[c.ps] = i | c.dp << 16;
    if (c.m > 0.f && c.okn > 0.f) src[N + c.ns] = i | c.dn << 16;
    if (c.okpn > 0.f && a[CNT_ON * N + i] + (c.m > 0.f) > 0)
      src[2 * N + c.pn] = i | c.dpn << 16;
  }
  __syncthreads();
  const int f = blockIdx.y * GATHER_THREADS + tid;
  const size_t plane = (size_t)N * d;
  const E* xb = x + (size_t)bar * plane + f;
  const bool has_bias = f < n;
  const E* gb = g + (size_t)bar * N * n + f;
  const float* upb = up + (size_t)bar * UP_PLANES * plane + f;
  const float* drb = dr + (size_t)bar * plane + f;
  E* dxb = dx + (size_t)bar * plane + f;
  float* pb = part + (size_t)bar * ((size_t)S * d + n) + f;
  const float g0 = R::load1(gates + f);
  float db = 0.f;
  for (int j = 0; j < N; ++j) {
    const size_t jd = (size_t)j * d;
    const float xv = R::load1(xb + jd);
    float dxv;
    if constexpr (kInPlace)
      dxv = dxb[jd];
    else
      dxv = drb[jd];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int e = src[r * N + j];
      if (e < 0) continue;
      const int i = e & 0xffff, dist = e >> 16;
      const float gv = R::load1(gates + (size_t)dist * d + f);
      if (!(R::rnd(xv * gv) > 0.f)) continue;
      const float u = upb[(r < 2 ? 0 : plane) + (size_t)i * d];
      dxv += R::rnd(u * gv);
      pb[(size_t)dist * d] += R::rnd(u * xv);
    }
    const float mj = m[j];
    if (mj > 0.f && R::rnd(xv * g0) > 0.f) {
      const float dy0 = upb[2 * plane + jd];
      dxv += dy0 * g0;
      pb[0] += dy0 * xv;
    }
    R::store1(dxb + jd, dxv);
    if (has_bias) db += R::load1(gb + (size_t)j * n) * mj;
  }
  if (has_bias) pb[(size_t)S * d] = db;
}

// The gather launch and the sum of its per-bar partials into out = [dgate
// (S, d) | dbias (n)], after the product kernel has written up and dr on
// stream st; part holds nbar rows of S d + n floats. nbar > 0, d %
// GATHER_THREADS == 0.
template <typename E>
cudaError_t gather_long(const E* x, const E* g, const int* aux,
                        const E* gates, const float* up, const float* dr,
                        E* dx, float* part, float* out, int nbar, int S,
                        int d, int n, cudaStream_t st) {
  const long long row = (long long)S * d + n;  // a partial row
  cudaError_t err;
  if ((err = cudaMemsetAsync(part, 0, sizeof(float) * row * nbar, st)) !=
      cudaSuccess)
    return err;
  const int gsmem = (int)(sizeof(int) * 4 * T * S);
  if ((err = cudaFuncSetAttribute(gcl_bwd_gather_long_kernel<E>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  gsmem)) != cudaSuccess)
    return err;
  gcl_bwd_gather_long_kernel<E><<<dim3(nbar, d / GATHER_THREADS),
                                  GATHER_THREADS, gsmem, st>>>(
      x, g, aux, gates, up, dr, dx, part, S, d, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return sum_rows(part, out, nbar, row, st);
}

}  // namespace gcl
