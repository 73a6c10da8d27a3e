// GCL training backward in one pass: dx, d(gate_table), dbias and dWbig.
//
// Replaces the Pallas kernel `_bwd_fused_kernel` of
// polyphemus_tpu/ops/kernels/gcl_pallas_bwd.py:289 (`gcl_backward_fused`,
// its pallas_call at :453). With gm = g * m and the forward of
// `gcl_eval.cu` (no epilogue), per bar:
//
//   dH_r  = gm @ W_r^T               (track blocks: each track's 32 rows only)
//   dx    = dH_root + the scatters of `gcl_bwd_data.cu`
//   dgate, dbias as there, summed over every bar
//   dW_r += h_r^T @ gm               (h_root = x; track blocks: own rows)
//
// so it computes what `gcl_bwd_data.cu` and `gcl_bwd_weight.cu` compute
// together, reading x and g once and recomputing the gathered
// pre-activations, relu masks and messages once instead of twice.
//
// Element type: fp32, or bf16 (the bf16 training policy). bf16 tensors are
// loaded into fp32 shared memory, every product sums in fp32, and values are
// rounded to bf16 where the Pallas body casts to its compute dtype: the
// elementwise products, the mean reciprocals, the same-column sums, the
// masked-mean upstreams of the onset and next relations, each scatter
// contribution of the gathered relations, the messages h_r, and dx. The
// self/onset path's dx and dgate contributions and every sum stay fp32.
//
// What bounds it on an H100: operations. The JAX kernel's CostEstimate is
// 4 * nbar * 128 * 8d * d flops, 2.75e11 at 256 bars and d = 512: 4.1 ms on
// the CUDA cores at 67 TFLOP/s in fp32 (this kernel), 0.28 ms on dense bf16
// tensor cores; its bytes (x, g, dx, Wbig, dWbig) need 0.034 ms.
//
// Design: only the products mix feature columns. One CTA owns (a chunk of
// bars, a 32-column tile c). Per bar it runs the dH product for its columns
// (4 x 4 outputs per thread and segment), then dx, dgate and dbias for those
// columns as `gcl_bwd_data.cu` does (scatters by shared-memory atomics),
// then rebuilds its columns of h_track, h_self, h_onset and h_next in shared
// memory over the dH tiles, and adds h_r[:, c]^T @ gm into rows c of the
// eight dW blocks of a per-chunk partial in device memory that only this CTA
// touches (read, add, write per bar; 4 x 4 outputs per thread, gm staged
// 128 columns at a time). A second launch sums the chunks' dW partials, and
// another their dgate/dbias rows, in a fixed order: no float atomics across
// CTAs, so the result does not depend on the order CTAs run in. 175 KB of
// shared memory, one CTA per SM.
#include "gcl_common.cuh"

namespace {

using namespace gcl;

constexpr int BC = 32;           // feature columns per CTA
constexpr int BK = 16;           // contracted features per chunk of dH
constexpr int BJ = 128;          // dW output columns per staged gm tile
constexpr int NSEG = 5;          // dH segments: track, self, onset, next, root
constexpr int THREADS = 256;

struct Smem : Statics {
  // dH tiles; segment 4 becomes dx, then segments 0-3 hold h_track,
  // h_self, h_onset and h_next of the same columns
  alignas(16) float dh[NSEG][N][BC];
  float xs[N][BC];               // x[:, tile]
  float gts[S][BC];              // gate_table[:, tile]
  float dgs[S][BC];              // dgate partial of this CTA's chunk
  float dbs[BC];                 // dbias partial of this CTA's chunk
  union {
    struct {
      float gms[BK][N];          // gm[:, chunk], k-major
      float ws[NBLK][BK][BC];    // W[blk*d + col, chunk], k-major
    } a;                         // the dH product
    float gmj[N][BJ];            // gm[:, j tile], the dW product
  } u;
};

template <typename E>
__global__ void __launch_bounds__(THREADS, 1)
gcl_bwd_fused_kernel(const E* __restrict__ x, const E* __restrict__ g,
                     const int* __restrict__ aux, const E* __restrict__ gates,
                     const E* __restrict__ wbig, E* __restrict__ dx,
                     float* __restrict__ part_w, float* __restrict__ part_gb,
                     int nbar, int d, int bars_per_chunk) {
  using V = Elem<E>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int c0 = blockIdx.x * BC;
  const int chunk = blockIdx.y;
  const int tid = threadIdx.x;
  const int b_lo = chunk * bars_per_chunk;
  const int b_hi = min(nbar, b_lo + bars_per_chunk);
  float* pw = part_w + (size_t)chunk * NBLK * d * d;

  for (int e = tid; e < S * BC; e += THREADS) {
    const int s = e / BC, q = e % BC;
    sm.gts[s][q] = V::load1(gates + (size_t)s * d + c0 + q);
    sm.dgs[s][q] = 0.f;
  }
  if (tid < BC) sm.dbs[tid] = 0.f;

  float (*dtr)[BC] = sm.dh[0];
  float (*dself)[BC] = sm.dh[1];
  float (*dcol)[BC] = sm.dh[2];
  float (*dnx)[BC] = sm.dh[3];
  float (*dxs)[BC] = sm.dh[4];

  for (int bar = b_lo; bar < b_hi; ++bar) {
    const E* xb = x + (size_t)bar * N * d;
    const E* gb = g + (size_t)bar * N * d;
    __syncthreads();  // the previous bar's tiles are consumed
    load_statics(sm, aux + (size_t)bar * N_AUX * N, tid, THREADS);
    for (int e = tid; e < N * BC; e += THREADS) {
      const int i = e / BC, q = e % BC;
      sm.xs[i][q] = V::load1(xb + (size_t)i * d + c0 + q);
    }
    __syncthreads();

    // ---- 1. dH[seg][:, tile] = gm @ W_blk[tile rows]^T, and dbias ----
    {
      const int ty = tid >> 3, tx = tid & 7;
      const int r0 = ty * 4, q0 = tx * 4;
      const int trk = r0 / S;            // the track of all 4 rows
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
          const float4 v = V::load4(gb + (size_t)row * d + j0 + k4);
          const float m = sm.m[row];
          sm.u.a.gms[k4 + 0][row] = v.x * m;
          sm.u.a.gms[k4 + 1][row] = v.y * m;
          sm.u.a.gms[k4 + 2][row] = v.z * m;
          sm.u.a.gms[k4 + 3][row] = v.w * m;
        }
#pragma unroll
        for (int j = 0; j < (NBLK * BC * BK / 4) / THREADS; ++j) {
          const int idx = tid + j * THREADS;
          const int blk = idx / (BC * BK / 4);
          const int rem = idx % (BC * BK / 4);
          const int cc = rem / (BK / 4), k4 = (rem % (BK / 4)) * 4;
          const float4 v = V::load4(wbig + ((size_t)blk * d + c0 + cc) * d + j0 + k4);
          sm.u.a.ws[blk][k4 + 0][cc] = v.x;
          sm.u.a.ws[blk][k4 + 1][cc] = v.y;
          sm.u.a.ws[blk][k4 + 2][cc] = v.z;
          sm.u.a.ws[blk][k4 + 3][cc] = v.w;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < BK; ++k) {
          const float4 a4 = *reinterpret_cast<const float4*>(&sm.u.a.gms[k][r0]);
          const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
          for (int s = 0; s < NSEG; ++s) {
            const int blk = s == 0 ? trk : T - 1 + s;
            const float4 b4 = *reinterpret_cast<const float4*>(&sm.u.a.ws[blk][k][q0]);
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
    }
    if (tid < BC) {
      float sb = 0.f;
      for (int i = 0; i < N; ++i) sb += V::load1(gb + (size_t)i * d + c0 + tid) * sm.m[i];
      sm.dbs[tid] += sb;
    }
    __syncthreads();

    // ---- 2. the masked mean upstreams of the onset and next relations ----
    for (int e = tid; e < N * BC; e += THREADS) {
      const int i = e / BC, q = e % BC;
      dcol[i][q] = V::rnd(dcol[i][q] * V::rnd(sm.ron[i]));
      dnx[i][q] = V::rnd(dnx[i][q] * V::rnd(sm.rnx[i]));
    }
    __syncthreads();

    // ---- 3. relu masks from the recomputed pre-activations, scatters ----
    for (int e = tid; e < N * BC; e += THREADS) {
      const int i = e / BC, q = e % BC;
      const int c = i % S;
      const float dmsg = dtr[i][q] * V::rnd(sm.rtr[i]);
      if (sm.okp[i] > 0.f) {
        const int src = sm.ps[i], dist = sm.dp[i];
        const float xv = sm.xs[src][q], gv = sm.gts[dist][q];
        if (V::rnd(xv * gv) > 0.f) {
          atomicAdd(&dxs[src][q], V::rnd(dmsg * gv));
          atomicAdd(&sm.dgs[dist][q], V::rnd(dmsg * xv));
        }
      }
      if (sm.okn[i] > 0.f) {
        const int src = sm.ns[i], dist = sm.dn[i];
        const float xv = sm.xs[src][q], gv = sm.gts[dist][q];
        if (V::rnd(xv * gv) > 0.f) {
          atomicAdd(&dxs[src][q], V::rnd(dmsg * gv));
          atomicAdd(&sm.dgs[dist][q], V::rnd(dmsg * xv));
        }
      }
      if (sm.okpn[i] > 0.f) {
        const int src = sm.pn[i], dist = sm.dpn[i];
        const float xv = sm.xs[src][q], gv = sm.gts[dist][q];
        if (V::rnd(xv * gv) > 0.f) {
          const float dz = (dnx[c][q] + dnx[S + c][q] + dnx[2 * S + c][q]
                            + dnx[3 * S + c][q]) - dnx[i][q];
          atomicAdd(&dxs[src][q], V::rnd(dz * gv));
          atomicAdd(&sm.dgs[dist][q], V::rnd(dz * xv));
        }
      }
      const float xv = sm.xs[i][q], g0 = sm.gts[0][q];
      if (sm.m[i] > 0.f && V::rnd(xv * g0) > 0.f) {
        const float dy0 = (dcol[c][q] + dcol[S + c][q] + dcol[2 * S + c][q]
                           + dcol[3 * S + c][q]) - dcol[i][q]
                          + dself[i][q] * sm.single[i];
        atomicAdd(&dxs[i][q], dy0 * g0);
        atomicAdd(&sm.dgs[0][q], dy0 * xv);
      }
    }
    __syncthreads();

    // ---- 4. the dx tile ----
    E* dxb = dx + (size_t)bar * N * d;
    for (int e = tid; e < N * BC; e += THREADS) {
      const int i = e / BC, q = e % BC;
      V::store1(dxb + (size_t)i * d + c0 + q, dxs[i][q]);
    }
    __syncthreads();  // the dH tiles are free

    // ---- 5. this tile's columns of the messages, as the forward builds them
    for (int e = tid; e < N * BC; e += THREADS) {
      const int i = e / BC, q = e % BC;
      const int c = i % S;
      const float vp = fmaxf(V::rnd(sm.xs[sm.ps[i]][q] * sm.gts[sm.dp[i]][q]),
                             0.f) * sm.okp[i];
      const float vn = fmaxf(V::rnd(sm.xs[sm.ns[i]][q] * sm.gts[sm.dn[i]][q]),
                             0.f) * sm.okn[i];
      float y[T], z[T];
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const int k = t * S + c;
        y[t] = fmaxf(V::rnd(sm.xs[k][q] * sm.gts[0][q]), 0.f) * sm.m[k];
        z[t] = fmaxf(V::rnd(sm.xs[sm.pn[k]][q] * sm.gts[sm.dpn[k]][q]), 0.f)
               * sm.okpn[k];
      }
      const float yi = y[i / S], zi = z[i / S];
      const float ysum = V::rnd(y[0] + y[1] + y[2] + y[3]);
      const float zsum = V::rnd(z[0] + z[1] + z[2] + z[3]);
      sm.dh[0][i][q] = V::rnd(V::rnd(vp + vn) * V::rnd(sm.rtr[i]));   // track
      sm.dh[1][i][q] = yi * sm.single[i];                            // self
      sm.dh[2][i][q] = V::rnd(V::rnd(ysum - yi) * V::rnd(sm.ron[i]));  // onset
      sm.dh[3][i][q] = V::rnd(V::rnd(zsum - zi) * V::rnd(sm.rnx[i]));  // next
    }

    // ---- 6. rows [c0, c0 + BC) of each dW block += h_r^T @ gm ----
    {
      const int ti = tid >> 5, tj = tid & 31;  // rows ti*4.., columns tj*4..
      const bool first = bar == b_lo;
      for (int j0 = 0; j0 < d; j0 += BJ) {
        __syncthreads();  // h built / the previous gm tile consumed
        for (int e = tid; e < N * (BJ / 4); e += THREADS) {
          const int i = e / (BJ / 4), j4 = (e % (BJ / 4)) * 4;
          float4 v = V::load4(gb + (size_t)i * d + j0 + j4);
          const float m = sm.m[i];
          v.x *= m; v.y *= m; v.z *= m; v.w *= m;
          *reinterpret_cast<float4*>(&sm.u.gmj[i][j4]) = v;
        }
        __syncthreads();
        for (int blk = 0; blk < NBLK; ++blk) {
          const int lo = blk < T ? blk * S : 0, hi = blk < T ? lo + S : N;
          const float (*h)[BC] = blk < T ? sm.dh[0]
                                 : (blk == NBLK - 1 ? sm.xs : sm.dh[blk - T + 1]);
          float* prow = pw + ((size_t)blk * d + c0 + ti * 4) * d + j0 + tj * 4;
          float acc[4][4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float4 v = first ? make_float4(0.f, 0.f, 0.f, 0.f)
                                   : *reinterpret_cast<const float4*>(prow + (size_t)r * d);
            acc[r][0] = v.x; acc[r][1] = v.y; acc[r][2] = v.z; acc[r][3] = v.w;
          }
          for (int k = lo; k < hi; ++k) {
            const float4 a4 = *reinterpret_cast<const float4*>(&h[k][ti * 4]);
            const float4 b4 = *reinterpret_cast<const float4*>(&sm.u.gmj[k][tj * 4]);
            const float av[4] = {a4.x, a4.y, a4.z, a4.w};
            const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
            *reinterpret_cast<float4*>(prow + (size_t)r * d) =
                make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        }
      }
    }
  }

  // ---- 7. this CTA's dgate / dbias partial of the chunk ----
  __syncthreads();
  float* pg = part_gb + (size_t)chunk * (S + 1) * d;
  for (int e = tid; e < S * BC; e += THREADS) {
    const int s = e / BC, q = e % BC;
    pg[(size_t)s * d + c0 + q] = sm.dgs[s][q];
  }
  if (tid < BC) pg[(size_t)S * d + c0 + tid] = sm.dbs[tid];
}

template <typename E>
int launch(const void* x, const void* g, const void* aux, const void* gates,
           const void* wbig, void* dx, void* part_w, void* part_gb,
           void* dwbig, void* out_gb, int nbar, int d, int nchunks,
           void* stream) {
  if (d % BJ != 0 || nchunks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (nbar <= 0) {
    cudaError_t err = cudaMemsetAsync(dwbig, 0, sizeof(float) * NBLK * d * d, st);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaMemsetAsync(out_gb, 0, sizeof(float) * (S + 1) * d, st);
  }
  const int bars_per_chunk = (nbar + nchunks - 1) / nchunks;
  const int used = (nbar + bars_per_chunk - 1) / bars_per_chunk;  // none empty
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      gcl_bwd_fused_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  gcl_bwd_fused_kernel<E><<<dim3(d / BC, used), THREADS, smem, st>>>(
      (const E*)x, (const E*)g, (const int*)aux, (const E*)gates,
      (const E*)wbig, (E*)dx, (float*)part_w, (float*)part_gb, nbar, d,
      bars_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = sum_rows((const float*)part_w, (float*)dwbig, used,
                 (long long)NBLK * d * d, st);
  if (err != cudaSuccess) return (int)err;
  return (int)sum_rows((const float*)part_gb, (float*)out_gb, used,
                       (long long)(S + 1) * d, st);
}

}  // namespace

// x, g (nbar, N, d); aux (nbar, N_AUX, N); gates (S, d); wbig (8d, d), all
// float tensors in fp32. Writes dx (nbar, N, d), dwbig (8d, d) and out_gb =
// [dgate (S, d) | dbias (d)], using part_w (nchunks, 8d, d) and part_gb
// (nchunks, (S + 1) * d) as scratch: chunk c sums bars [c * bpc, (c + 1) *
// bpc), bpc = ceil(nbar / nchunks).
extern "C" int gcl_bwd_fused_launch(const void* x, const void* g,
                                    const void* aux, const void* gates,
                                    const void* wbig, void* dx, void* part_w,
                                    void* part_gb, void* dwbig, void* out_gb,
                                    int nbar, int d, int nchunks,
                                    void* stream) {
  return launch<float>(x, g, aux, gates, wbig, dx, part_w, part_gb, dwbig,
                       out_gb, nbar, d, nchunks, stream);
}

// The same with x, g, gates, wbig and dx in bf16 (the partials and the
// summed gradients stay fp32).
extern "C" int gcl_bwd_fused_bf16_launch(const void* x, const void* g,
                                         const void* aux, const void* gates,
                                         const void* wbig, void* dx,
                                         void* part_w, void* part_gb,
                                         void* dwbig, void* out_gb, int nbar,
                                         int d, int nchunks, void* stream) {
  return launch<__nv_bfloat16>(x, g, aux, gates, wbig, dx, part_w, part_gb,
                               dwbig, out_gb, nbar, d, nchunks, stream);
}
