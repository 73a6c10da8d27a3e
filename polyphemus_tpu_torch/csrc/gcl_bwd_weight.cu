// GCL training backward, weight half: dWbig (8d, d).
//
// Replaces the Pallas kernel `_bwd_weight_kernel` of
// polyphemus_tpu/ops/kernels/gcl_pallas_bwd.py (kernel B of
// `gcl_backward_pallas`, called by the custom VJP `gcl_fused`). With
// gm = g * m and the message operands h_r of the forward (`gcl.gcl_fwd`):
//
//   dW_r = sum over bars and rows of h_r[row, :]^T gm[row, :]
//
// for the eight packed blocks [track 0..3 | self | onset | next | root]
// (h_root = x). The four track blocks contract only their own track's 32
// rows of each bar, the other four all 128.
//
// What bounds it on an H100: operations, a split-K product with K = nbar *
// 128 (nbar * 32 for the track blocks): 2 * 640 * d * d flops per bar,
// 335 MFLOP at d = 512, in fp32 on the CUDA cores.
//
// Design: column i of every h_r depends only on column i of x and of the
// gate table. So a CTA that owns a 64 x 64 output tile (input features i,
// output features j) of one block recomputes just its 64 columns of h_r for
// each bar of its chunk of bars, in shared memory, with the forward's fp32
// operations; no h tensor ever reaches device memory. It accumulates the
// tile in registers (4 x 4 per thread) over the chunk, writes it as one
// partial, and a second launch sums the chunks' partials in a fixed order.
#include "gcl_common.cuh"

namespace {

using namespace gcl;

constexpr int BT = 64;           // output tile (i and j)
constexpr int THREADS = 256;

struct Smem : Statics {
  alignas(16) float xs[N][BT];   // x[:, i tile]
  float hs[N][BT];               // h_r[:, i tile]
  float gs[N][BT];               // gm[:, j tile]
  float gts[S][BT];              // gate_table[:, i tile]
};

__global__ void __launch_bounds__(THREADS, 2)
gcl_bwd_weight_kernel(const float* __restrict__ x, const float* __restrict__ g,
                      const int* __restrict__ aux,
                      const float* __restrict__ gates,
                      float* __restrict__ part, int nbar, int d,
                      int bars_per_chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int ntile = d / BT;
  const int i0 = (blockIdx.x / ntile) * BT, j0 = (blockIdx.x % ntile) * BT;
  const int blk = blockIdx.y;
  const int chunk = blockIdx.z;
  const int tid = threadIdx.x;
  const int ti = tid >> 4, tj = tid & 15;
  // rows of each bar that this block contracts
  const int lo = blk < T ? blk * S : 0, hi = blk < T ? lo + S : N;
  // x rows the messages read: a track's sources lie in its own track
  const int xlo = blk < T ? lo : 0, xhi = blk < T ? hi : N;
  const float(*h)[BT] = blk == NBLK - 1 ? sm.xs : sm.hs;

  for (int e = tid; e < S * BT; e += THREADS)
    sm.gts[e / BT][e % BT] = gates[(size_t)(e / BT) * d + i0 + e % BT];

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  const int b_lo = chunk * bars_per_chunk;
  const int b_hi = min(nbar, b_lo + bars_per_chunk);
  for (int bar = b_lo; bar < b_hi; ++bar) {
    const float* xb = x + (size_t)bar * N * d;
    const float* gb = g + (size_t)bar * N * d;
    __syncthreads();  // the previous bar's tiles are consumed
    load_statics(sm, aux + (size_t)bar * N_AUX * N, tid, THREADS);
    for (int e = tid; e < (xhi - xlo) * (BT / 4); e += THREADS) {
      const int i = xlo + e / (BT / 4), q4 = (e % (BT / 4)) * 4;
      *reinterpret_cast<float4*>(&sm.xs[i][q4]) =
          *reinterpret_cast<const float4*>(xb + (size_t)i * d + i0 + q4);
    }
    for (int e = tid; e < (hi - lo) * (BT / 4); e += THREADS) {
      const int i = lo + e / (BT / 4), q4 = (e % (BT / 4)) * 4;
      *reinterpret_cast<float4*>(&sm.gs[i][q4]) =
          *reinterpret_cast<const float4*>(gb + (size_t)i * d + j0 + q4);
    }
    __syncthreads();

    // h_r[:, i tile] as the forward builds it, and gm = g * m
    for (int e = tid; e < (hi - lo) * BT; e += THREADS) {
      const int i = lo + e / BT, q = e % BT;
      const int c = i % S;
      sm.gs[i][q] *= sm.m[i];
      if (blk < T) {
        const float vp = fmaxf(sm.xs[sm.ps[i]][q] * sm.gts[sm.dp[i]][q], 0.f)
                         * sm.okp[i];
        const float vn = fmaxf(sm.xs[sm.ns[i]][q] * sm.gts[sm.dn[i]][q], 0.f)
                         * sm.okn[i];
        sm.hs[i][q] = (vp + vn) * sm.rtr[i];
      } else if (blk == T) {
        sm.hs[i][q] = fmaxf(sm.xs[i][q] * sm.gts[0][q], 0.f) * sm.m[i]
                      * sm.single[i];
      } else if (blk == T + 1) {
        float y[T];
#pragma unroll
        for (int t = 0; t < T; ++t)
          y[t] = fmaxf(sm.xs[t * S + c][q] * sm.gts[0][q], 0.f) * sm.m[t * S + c];
        const float yi = y[i / S];
        sm.hs[i][q] = (y[0] + y[1] + y[2] + y[3] - yi) * sm.ron[i];
      } else if (blk == T + 2) {
        float z[T];
#pragma unroll
        for (int t = 0; t < T; ++t) {
          const int k = t * S + c;
          z[t] = fmaxf(sm.xs[sm.pn[k]][q] * sm.gts[sm.dpn[k]][q], 0.f)
                 * sm.okpn[k];
        }
        const float zi = z[i / S];
        sm.hs[i][q] = (z[0] + z[1] + z[2] + z[3] - zi) * sm.rnx[i];
      }
    }
    __syncthreads();

    // acc += h_r[rows, i tile]^T @ gm[rows, j tile]
    for (int k = lo; k < hi; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&h[k][ti * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&sm.gs[k][tj * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
  }

  float* pc = part + (size_t)chunk * NBLK * d * d;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    *reinterpret_cast<float4*>(
        pc + ((size_t)blk * d + i0 + ti * 4 + r) * d + j0 + tj * 4) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
}

}  // namespace

// x, g (nbar, N, d); aux (nbar, N_AUX, N); gates (S, d). Writes dwbig
// (8d, d), using part (nchunks, 8d, d) as scratch: chunk c sums bars
// [c * bars_per_chunk, (c + 1) * bars_per_chunk).
extern "C" int gcl_bwd_weight_launch(const void* x, const void* g,
                                     const void* aux, const void* gates,
                                     void* part, void* dwbig, int nbar, int d,
                                     int nchunks, void* stream) {
  if (d % BT != 0 || nchunks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int bars_per_chunk = nbar > 0 ? (nbar + nchunks - 1) / nchunks : 0;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      gcl_bwd_weight_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int ntile = d / BT;
  gcl_bwd_weight_kernel<<<dim3(ntile * ntile, NBLK, nchunks), THREADS, smem,
                          st>>>(
      (const float*)x, (const float*)g, (const int*)aux, (const float*)gates,
      (float*)part, nbar, d, bars_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)sum_rows((const float*)part, (float*)dwbig, nchunks,
                       (long long)NBLK * d * d, st);
}
