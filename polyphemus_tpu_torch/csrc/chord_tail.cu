// Chord tail: chord decode -> unembed -> argmax, token ids only.
//
// Replaces the Pallas kernel `_kernel` of
// polyphemus_tpu/ops/kernels/chord_tail.py (via `chord_tail_tokens`). For
// each cell and each of the 15 note slots:
//
//   h     = x @ W_slot + b_slot                          (d values)
//   pitch = h[:d/2] @ P_track + pb_track   (drums unembed on track 0,
//                                           the melodic one elsewhere)
//   dur   = h[d/2:] @ D + db
//   ids   = (argmax pitch, argmax dur)     first index among ties
//
// Only the int32 ids reach device memory, in the (bar, T, S, slot, 2) layout
// of the JAX function; the logits and the slot hiddens stay on chip.
//
// What bounds it on an H100: operations. Per cell and slot it does
// 2 * d * d + 2 * (d/2) * (131 + 99) flops (0.64 MFLOP at d = 512) and reads
// d * 4 bytes of state, so fp32 FMA throughput on the CUDA cores (no TF32)
// is the limit.
//
// Design: one CTA per (bar, track, slot): a 32-row tile, one slot. The slot
// projection is a shared-memory-tiled SIMT GEMM (8 x 8 values per thread)
// whose result h (32 x d) is kept in dynamic shared memory (66 KB at
// d = 512). Then each of 230 threads owns one vocabulary column (131 pitch,
// 99 duration) for all 32 rows, streaming its weight column once per CTA,
// and one warp per (row, kind) takes the argmax. The TPU's -inf vocabulary
// padding (128-lane tiling) is gone: the loops stop at the vocabulary edge.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int R = 32;            // rows per CTA: one track row of one bar
constexpr int T = 4;             // tracks per bar
constexpr int BK = 16;           // k chunk of the slot projection
constexpr int CT = 512;          // output columns per projection tile
constexpr int THREADS = 256;
constexpr int NS = 15;           // note slots
constexpr int LG = 232;          // logits row stride (131 + 99, padded)

__global__ void __launch_bounds__(THREADS, 2)
chord_tail_kernel(const float* __restrict__ x, const float* __restrict__ ck,
                  const float* __restrict__ cb, const float* __restrict__ pkd,
                  const float* __restrict__ pbd, const float* __restrict__ pkn,
                  const float* __restrict__ pbn, const float* __restrict__ dk,
                  const float* __restrict__ db, int* __restrict__ ids,
                  int d, int vp, int vd) {
  extern __shared__ __align__(16) float smem[];
  const int sh_ld = d + 4;
  float* as = smem;                       // [BK][R]   x chunk, k-major
  float* bs = as + BK * R;                // [BK][CT]  weight chunk; later logits [R][LG]
  float* sh = bs + BK * CT;               // [R][d+4]  slot hiddens

  const int tile = blockIdx.x;            // bar * T + track
  const int trk = tile % T;
  const int slot = blockIdx.y;
  const int tid = threadIdx.x;
  const int h = d / 2;
  const float* xt = x + (size_t)tile * R * d;
  const size_t ldc = (size_t)NS * d;
  const float* wc = ck + (size_t)slot * d;
  const float* bc = cb + (size_t)slot * d;

  // ---- 1. h = x_tile @ W_slot + b_slot -> sh ----
  const int ty = tid >> 6, tx = tid & 63;  // rows ty*8.., cols tx*4.. and +256
  for (int n0 = 0; n0 < d; n0 += CT) {
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
    for (int k0 = 0; k0 < d; k0 += BK) {
      {
        const int r = tid >> 3, q = (tid & 7) * 2;
        const float2 v = *reinterpret_cast<const float2*>(xt + (size_t)r * d + k0 + q);
        as[q * R + r] = v.x;
        as[(q + 1) * R + r] = v.y;
      }
#pragma unroll
      for (int j = 0; j < (BK * CT / 4) / THREADS; ++j) {
        const int idx = tid + j * THREADS;
        const int q = idx / (CT / 4), c4 = idx % (CT / 4);
        const int col = n0 + c4 * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (col < d)
          v = *reinterpret_cast<const float4*>(wc + (size_t)(k0 + q) * ldc + col);
        *reinterpret_cast<float4*>(&bs[q * CT + c4 * 4]) = v;
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < BK; ++q) {
        const float4 a0 = *reinterpret_cast<const float4*>(&as[q * R + ty * 8]);
        const float4 a1 = *reinterpret_cast<const float4*>(&as[q * R + ty * 8 + 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&bs[q * CT + tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&bs[q * CT + CT / 2 + tx * 4]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int col = n0 + hh * (CT / 2) + tx * 4;
      if (col >= d) continue;
      const float4 bb = *reinterpret_cast<const float4*>(bc + col);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4 o = make_float4(acc[r][hh * 4 + 0] + bb.x, acc[r][hh * 4 + 1] + bb.y,
                                     acc[r][hh * 4 + 2] + bb.z, acc[r][hh * 4 + 3] + bb.w);
        *reinterpret_cast<float4*>(&sh[(ty * 8 + r) * sh_ld + col]) = o;
      }
    }
  }
  __syncthreads();

  // ---- 2. logits: thread j owns vocabulary column j for all R rows ----
  float* lg = bs;  // [R][LG]; the weight chunk buffer is free now
  const int j = tid;
  if (j < vp + vd) {
    const bool pitch = j < vp;
    const float* w = pitch ? (trk == 0 ? pkd : pkn) : dk;
    const int ldw = pitch ? vp : vd;
    const int col = pitch ? j : j - vp;
    const int koff = pitch ? 0 : h;
    const float b = pitch ? (trk == 0 ? pbd : pbn)[col] : db[col];
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int k = 0; k < h; k += 4) {
      const float w0 = w[(size_t)(k + 0) * ldw + col];
      const float w1 = w[(size_t)(k + 1) * ldw + col];
      const float w2 = w[(size_t)(k + 2) * ldw + col];
      const float w3 = w[(size_t)(k + 3) * ldw + col];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(&sh[r * sh_ld + koff + k]);
        acc[r] = fmaf(a.x, w0, acc[r]);
        acc[r] = fmaf(a.y, w1, acc[r]);
        acc[r] = fmaf(a.z, w2, acc[r]);
        acc[r] = fmaf(a.w, w3, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) lg[r * LG + j] = acc[r] + b;
  }
  __syncthreads();

  // ---- 3. argmax per (row, kind), one warp per task, first index on ties ----
  const int warp = tid >> 5, lane = tid & 31;
  for (int task = warp; task < 2 * R; task += THREADS / 32) {
    const int r = task >> 1, kind = task & 1;
    const int lo = kind ? vp : 0, len = kind ? vd : vp;
    float bv = -CUDART_INF_F;
    int bi = 0x7fffffff;
    for (int c = lane; c < len; c += 32) {
      const float v = lg[r * LG + lo + c];
      if (v > bv || (v == bv && c < bi)) { bv = v; bi = c; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0)
      ids[(((size_t)tile * R + r) * NS + slot) * 2 + kind] = bi;
  }
}

}  // namespace

extern "C" int chord_tail_launch(const void* x, const void* ck, const void* cb,
                                 const void* pkd, const void* pbd,
                                 const void* pkn, const void* pbn,
                                 const void* dk, const void* db, void* ids,
                                 int nbar, int d, int n_slots, int vp, int vd,
                                 void* stream) {
  if (nbar <= 0) return 0;
  if (n_slots != NS || d % 128 != 0 || vp + vd > THREADS || vp + vd > LG)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)((BK * R + BK * CT + R * (d + 4)) * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      chord_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nbar * T, NS);
  chord_tail_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)ck, (const float*)cb, (const float*)pkd,
      (const float*)pbd, (const float*)pkn, (const float*)pbn,
      (const float*)dk, (const float*)db, (int*)ids, d, vp, vd);
  return (int)cudaGetLastError();
}
