// GCL training backward, data half: dx, d(gate_table) and dbias.
//
// Replaces the Pallas kernel `_bwd_data_kernel` of
// polyphemus_tpu/ops/kernels/gcl_pallas_bwd.py (kernel A of
// `gcl_backward_pallas`, called by the custom VJP `gcl_fused`). With
// gm = g * m and the forward of `gcl_eval.cu` (no epilogue), per bar:
//
//   dH_r     = gm @ W_r^T            (track blocks: each track's 32 rows only)
//   dx       = dH_root
//            + scatter of relu'(pre) * dmsg * gate over the track sources
//            + scatter of relu'(pre) * dz * gate over the NEXT sources
//            + relu'(x * g0) * dy0 * g0
//   dgate[s] = sum of relu'(pre) * upstream * x[src] over the cells at
//              distance s (dy0 * x for s = 0), summed over every bar
//   dbias    = sum of gm over every cell of every bar
//
// where dmsg = dH_track * r_track, dz = colsum(dH_next * r_next) - itself,
// dy0 = colsum(dH_onset * r_onset) - itself + dH_self * single.
//
// What bounds it on an H100: operations, the first product (2 * 128 * 5d * d
// flops per bar, 335 MFLOP at d = 512) in fp32 on the CUDA cores.
//
// Design: the first product is the only step that mixes feature columns;
// everything after it is elementwise in the column. So one CTA owns a (bar,
// 32-column tile) pair: a bar's fp32 state (128 x d, 256 KB at d = 512) would
// not fit in shared memory, a column tile does. The CTA runs the product for
// its columns as a shared-memory-tiled SIMT GEMM over the d contracted
// features (4 x 4 outputs per thread and segment), keeps the five dH tiles in
// shared memory, recomputes the gathered pre-activations with the forward's
// fp32 product (so the relu masks agree), and scatters into its dx tile and a
// dgate tile with shared-memory atomics. dgate and dbias sum over every bar:
// each CTA writes its partial row, and a second launch sums the rows in a
// fixed order (no global atomics, so the result does not depend on the order
// CTAs run in).
#include "gcl_common.cuh"

namespace {

using namespace gcl;

constexpr int BC = 32;           // feature columns per CTA
constexpr int BK = 16;           // contracted features per chunk
constexpr int NSEG = 5;          // dH segments: track, self, onset, next, root
constexpr int THREADS = 256;

struct Smem : Statics {
  alignas(16) float gms[BK][N];  // gm[:, chunk], k-major
  float ws[NBLK][BK][BC];        // W[blk*d + col, chunk], k-major
  float dh[NSEG][N][BC];         // dH tiles; segment 4 becomes dx
  float xs[N][BC];               // x[:, tile]
  float gts[S][BC];              // gate_table[:, tile]
  float dgs[S][BC];              // dgate partial of this CTA
};

__global__ void __launch_bounds__(THREADS, 1)
gcl_bwd_data_kernel(const float* __restrict__ x, const float* __restrict__ g,
                    const int* __restrict__ aux,
                    const float* __restrict__ gates,
                    const float* __restrict__ wbig, float* __restrict__ dx,
                    float* __restrict__ part, int d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int c0 = blockIdx.x * BC;
  const int bar = blockIdx.y;
  const int tid = threadIdx.x;
  const float* xb = x + (size_t)bar * N * d;
  const float* gb = g + (size_t)bar * N * d;

  load_statics(sm, aux + (size_t)bar * N_AUX * N, tid, THREADS);
  for (int e = tid; e < N * BC; e += THREADS) {
    const int i = e / BC, q = e % BC;
    sm.xs[i][q] = xb[(size_t)i * d + c0 + q];
    if (i < S) {
      sm.gts[i][q] = gates[(size_t)i * d + c0 + q];
      sm.dgs[i][q] = 0.f;
    }
  }
  __syncthreads();

  // ---- 1. dH[seg][:, tile] = gm @ W_blk[tile rows]^T ----
  const int ty = tid >> 3, tx = tid & 7;
  const int r0 = ty * 4, q0 = tx * 4;
  const int trk = r0 / S;              // the track of all 4 rows
  float acc[NSEG][4][4];
#pragma unroll
  for (int s = 0; s < NSEG; ++s)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[s][r][c] = 0.f;

  for (int j0 = 0; j0 < d; j0 += BK) {
#pragma unroll
    for (int j = 0; j < (N * BK / 4) / THREADS; ++j) {
      const int idx = tid + j * THREADS;
      const int row = idx / (BK / 4), k4 = (idx % (BK / 4)) * 4;
      const float4 v = *reinterpret_cast<const float4*>(
          gb + (size_t)row * d + j0 + k4);
      const float m = sm.m[row];
      sm.gms[k4 + 0][row] = v.x * m;
      sm.gms[k4 + 1][row] = v.y * m;
      sm.gms[k4 + 2][row] = v.z * m;
      sm.gms[k4 + 3][row] = v.w * m;
    }
#pragma unroll
    for (int j = 0; j < (NBLK * BC * BK / 4) / THREADS; ++j) {
      const int idx = tid + j * THREADS;
      const int blk = idx / (BC * BK / 4);
      const int rem = idx % (BC * BK / 4);
      const int cc = rem / (BK / 4), k4 = (rem % (BK / 4)) * 4;
      const float4 v = *reinterpret_cast<const float4*>(
          wbig + ((size_t)blk * d + c0 + cc) * d + j0 + k4);
      sm.ws[blk][k4 + 0][cc] = v.x;
      sm.ws[blk][k4 + 1][cc] = v.y;
      sm.ws[blk][k4 + 2][cc] = v.z;
      sm.ws[blk][k4 + 3][cc] = v.w;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&sm.gms[k][r0]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int s = 0; s < NSEG; ++s) {
        const int blk = s == 0 ? trk : T - 1 + s;
        const float4 b4 = *reinterpret_cast<const float4*>(&sm.ws[blk][k][q0]);
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[s][r][c] = fmaf(av[r], bv[c], acc[s][r][c]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int s = 0; s < NSEG; ++s)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<float4*>(&sm.dh[s][r0 + r][q0]) =
          make_float4(acc[s][r][0], acc[s][r][1], acc[s][r][2], acc[s][r][3]);
  __syncthreads();

  // ---- 2. the masked mean upstreams: dnx and dcol in place ----
  float (*dtr)[BC] = sm.dh[0];
  float (*dself)[BC] = sm.dh[1];
  float (*dcol)[BC] = sm.dh[2];
  float (*dnx)[BC] = sm.dh[3];
  float (*dxs)[BC] = sm.dh[4];
  for (int e = tid; e < N * BC; e += THREADS) {
    const int i = e / BC, q = e % BC;
    dcol[i][q] *= sm.ron[i];
    dnx[i][q] *= sm.rnx[i];
  }
  __syncthreads();

  // ---- 3. relu masks from the recomputed pre-activations, scatters ----
  for (int e = tid; e < N * BC; e += THREADS) {
    const int i = e / BC, q = e % BC;
    const int c = i % S;
    const float dmsg = dtr[i][q] * sm.rtr[i];
    if (sm.okp[i] > 0.f) {
      const int src = sm.ps[i], dist = sm.dp[i];
      const float xv = sm.xs[src][q], gv = sm.gts[dist][q];
      if (xv * gv > 0.f) {
        atomicAdd(&dxs[src][q], dmsg * gv);
        atomicAdd(&sm.dgs[dist][q], dmsg * xv);
      }
    }
    if (sm.okn[i] > 0.f) {
      const int src = sm.ns[i], dist = sm.dn[i];
      const float xv = sm.xs[src][q], gv = sm.gts[dist][q];
      if (xv * gv > 0.f) {
        atomicAdd(&dxs[src][q], dmsg * gv);
        atomicAdd(&sm.dgs[dist][q], dmsg * xv);
      }
    }
    if (sm.okpn[i] > 0.f) {
      const int src = sm.pn[i], dist = sm.dpn[i];
      const float xv = sm.xs[src][q], gv = sm.gts[dist][q];
      if (xv * gv > 0.f) {
        const float dz = (dnx[c][q] + dnx[S + c][q] + dnx[2 * S + c][q]
                          + dnx[3 * S + c][q]) - dnx[i][q];
        atomicAdd(&dxs[src][q], dz * gv);
        atomicAdd(&sm.dgs[dist][q], dz * xv);
      }
    }
    const float xv = sm.xs[i][q], g0 = sm.gts[0][q];
    if (sm.m[i] > 0.f && xv * g0 > 0.f) {
      const float dy0 = (dcol[c][q] + dcol[S + c][q] + dcol[2 * S + c][q]
                         + dcol[3 * S + c][q]) - dcol[i][q]
                        + dself[i][q] * sm.single[i];
      atomicAdd(&dxs[i][q], dy0 * g0);
      atomicAdd(&sm.dgs[0][q], dy0 * xv);
    }
  }
  __syncthreads();

  // ---- 4. dx tile, and this CTA's dgate / dbias partial row ----
  float* dxb = dx + (size_t)bar * N * d;
  for (int e = tid; e < N * BC; e += THREADS) {
    const int i = e / BC, q = e % BC;
    dxb[(size_t)i * d + c0 + q] = dxs[i][q];
  }
  float* pb = part + (size_t)bar * (S + 1) * d;
  for (int e = tid; e < S * BC; e += THREADS) {
    const int s = e / BC, q = e % BC;
    pb[(size_t)s * d + c0 + q] = sm.dgs[s][q];
  }
  if (tid < BC) {
    float sb = 0.f;
    for (int i = 0; i < N; ++i) sb += gb[(size_t)i * d + c0 + tid] * sm.m[i];
    pb[(size_t)S * d + c0 + tid] = sb;
  }
}

}  // namespace

// x, g (nbar, N, d); aux (nbar, N_AUX, N); gates (S, d); wbig (8d, d).
// Writes dx (nbar, N, d) and out = [dgate (S, d) | dbias (d)], using part
// (nbar, (S + 1) * d) as scratch for the per-bar partials.
extern "C" int gcl_bwd_data_launch(const void* x, const void* g,
                                   const void* aux, const void* gates,
                                   const void* wbig, void* dx, void* part,
                                   void* out, int nbar, int d, void* stream) {
  if (d % BC != 0 || d % BK != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (nbar <= 0)
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * (S + 1) * d, st);
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      gcl_bwd_data_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  gcl_bwd_data_kernel<<<dim3(d / BC, nbar), THREADS, smem, st>>>(
      (const float*)x, (const float*)g, (const int*)aux, (const float*)gates,
      (const float*)wbig, (float*)dx, (float*)part, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)sum_rows((const float*)part, (float*)out, nbar,
                       (long long)(S + 1) * d, st);
}
