// GCL layers in one launch: K epilogue-fused eval layers, or one training
// forward layer.
//
// Replaces the Pallas kernels `_kernel` (with its eval epilogue, K = 1, and
// without it as the forward of the training custom VJP `gcl_fused`) and
// `_kernel_chain` (K >= 2) of polyphemus_tpu/ops/kernels/gcl_pallas.py,
// reached through `gcl_apply_pallas` and `gcl_apply_pallas_chain`. It
// computes what `_layer_math` computes, per bar of n = 4 x 32 cells:
//
//   A   = [h_track | h_self | h_onset | h_next | x]            (n x 5d)
//   out = relu(((A @ [W_t; W0; W_on; W_next; root] + bias) * m * ea + eb) * m) + x
//   (training forward, no epilogue: out = (A @ [...] + bias) * m)
//
// with W_t the weight of the row block's own track. The messages come from
// direct indexed loads through the aux channels; the TPU's one-hot selection
// matmuls (Mosaic has no gather) are gone.
//
// What bounds it on an H100: operations. Per bar and layer the product is
// 2 * 128 * 5d * d flops (335 MFLOP at d = 512) against 2 * 128 * d * 4
// bytes of node state, so fp32 FMA throughput on the CUDA cores (no TF32:
// fp32 parity comes first) is the limit; device memory is not.
//
// Design: one CTA per bar. The per-bar statics (source rows, gate
// distances, mean reciprocals, mask, single-node flag) are decoded into
// shared memory once per launch and reused by all K layers. The A operand is
// never stored in device memory: for each chunk of BK features, the CTA
// stages x[:, chunk] and the gate rows in shared memory, builds the five
// message segments of A for that chunk there, and multiplies them with the
// matching BK rows of the eight packed weight blocks. The product is a plain
// shared-memory-tiled SIMT GEMM, output tile 128 x 128, 8 x 8 values per
// thread. A bar's fp32 state (128 x d) is 256 KB at d = 512, more than a
// CTA's shared memory, so between chained layers it goes to a per-bar
// ping-pong buffer in device memory (it stays in L2) behind __syncthreads().
//
// Element type: fp32, or bf16 (`gcl_eval_bf16`, `gcl_fwd_bf16`). bf16
// tensors are loaded into fp32 shared memory, the products sum in fp32, and
// the values are rounded to bf16 where the Pallas body casts to its compute
// dtype: each elementwise product, the mean reciprocals, the same-column
// sums, the message segments of A, and the two projection products, which
// keep separate accumulators (base = round(shared segments) + bias, then +
// round(track segment)); the epilogue rounds after each of its bf16
// operations (* A, + B, + x). In fp32 every rounding step is the identity
// and the code is the fp32 kernel's.
#include "gcl_common.cuh"

namespace {

using namespace gcl;

constexpr int BN = 128;          // output columns per tile
constexpr int BK = 8;            // features per chunk
constexpr int NSEG = 5;          // A segments: track, self, onset, next, root
constexpr int THREADS = 256;

struct Smem : Statics {
  alignas(16) float as[NSEG * BK][N];  // A chunk, k-major
  float bs[NBLK][BK][BN];        // weight rows of the chunk, per block
  float xs[N][BK];               // x[:, chunk]
  float y0[N][BK];               // relu(x * g0) * m
  float zz[N][BK];               // NEXT-source messages
  float gs[S][BK];               // gate_table[:, chunk]
};

// EPI: the eval epilogue (folded batch-norm, relu, residual) over K chained
// layers; without it, K = 1 and the output is (A @ W + bias) * m, the
// training forward. E: the element type of every float tensor. bf16 keeps
// two accumulator tiles, so it runs one CTA per SM.
template <typename E, bool EPI>
__global__ void __launch_bounds__(THREADS, Elem<E>::kExact ? 2 : 1)
gcl_eval_kernel(const E* x, const int* aux, const E* gates,
                const E* wbigs, const E* biases, const E* eas,
                const E* ebs, E* out, E* scratch, int d, int K) {
  using V = Elem<E>;
  constexpr bool SPLIT = !V::kExact;  // two roundings: shared, then track
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int bar = blockIdx.x;
  const int tid = threadIdx.x;

  // ---- per-bar statics, shared by every layer of the launch ----
  load_statics(sm, aux + (size_t)bar * N_AUX * N, tid, THREADS);
  __syncthreads();

  // GEMM thread tile: rows r0..r0+7, columns c0..c0+3 and c0+64..c0+67
  const int ty = tid >> 4, tx = tid & 15;
  const int r0 = ty * 8;
  const int trk = r0 / S;               // the track of all 8 rows
  const int c0 = tx * 4;
  const size_t bar_off = (size_t)bar * N * d;

  for (int k = 0; k < K; ++k) {
    // ping-pong: layer K-1 writes `out`, layer K-2 `scratch`, and so on
    const E* xin = (k == 0) ? x : (((K - k) % 2 == 0) ? out : scratch);
    E* xo = ((K - 1 - k) % 2 == 0) ? out : scratch;
    xin += bar_off;
    xo += bar_off;
    const E* W = wbigs + (size_t)k * NBLK * d * d;
    const E* bias = biases + (size_t)k * d;
    const E* ea = EPI ? eas + (size_t)k * d : nullptr;
    const E* eb = EPI ? ebs + (size_t)k * d : nullptr;

    for (int n0 = 0; n0 < d; n0 += BN) {
      float acc[8][8];
      float acct[8][8];  // bf16 only: the track segment's product
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
      if constexpr (SPLIT) {
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acct[r][c] = 0.f;
      }

      for (int f0 = 0; f0 < d; f0 += BK) {
        // 1. stage x[:, f0:f0+BK], gates[:, f0:f0+BK] and the weight rows
        {
          const int i = tid >> 1, q = (tid & 1) * 4;
          *reinterpret_cast<float4*>(&sm.xs[i][q]) =
              V::load4(xin + (size_t)i * d + f0 + q);
          const int s = tid >> 3, g = tid & 7;
          sm.gs[s][g] = V::load1(gates + (size_t)s * d + f0 + g);
        }
#pragma unroll
        for (int j = 0; j < (NBLK * BK * BN / 4) / THREADS; ++j) {
          const int idx = tid + j * THREADS;
          const int blk = idx / (BK * BN / 4);
          const int rem = idx % (BK * BN / 4);
          const int r = rem / (BN / 4), c4 = rem % (BN / 4);
          *reinterpret_cast<float4*>(&sm.bs[blk][r][c4 * 4]) =
              V::load4(W + ((size_t)blk * d + f0 + r) * d + n0 + c4 * 4);
        }
        __syncthreads();

        // 2. y0 = relu(x * g0) * m and the NEXT-source messages z
#pragma unroll
        for (int j = 0; j < N * BK / THREADS; ++j) {
          const int e = tid + j * THREADS;
          const int i = e / BK, q = e % BK;
          sm.y0[i][q] = fmaxf(V::rnd(sm.xs[i][q] * sm.gs[0][q]), 0.f) * sm.m[i];
          sm.zz[i][q] = fmaxf(V::rnd(sm.xs[sm.pn[i]][q] * sm.gs[sm.dpn[i]][q]),
                              0.f) * sm.okpn[i];
        }
        __syncthreads();

        // 3. the five A segments of this chunk
#pragma unroll
        for (int j = 0; j < N * BK / THREADS; ++j) {
          const int e = tid + j * THREADS;
          const int q = e / N, i = e % N;
          const int c = i % S;
          const float vp = fmaxf(V::rnd(sm.xs[sm.ps[i]][q] * sm.gs[sm.dp[i]][q]),
                                 0.f) * sm.okp[i];
          const float vn = fmaxf(V::rnd(sm.xs[sm.ns[i]][q] * sm.gs[sm.dn[i]][q]),
                                 0.f) * sm.okn[i];
          const float y = sm.y0[i][q], z = sm.zz[i][q];
          const float ysum = V::rnd(sm.y0[c][q] + sm.y0[S + c][q]
                                    + sm.y0[2 * S + c][q] + sm.y0[3 * S + c][q]);
          const float zsum = V::rnd(sm.zz[c][q] + sm.zz[S + c][q]
                                    + sm.zz[2 * S + c][q] + sm.zz[3 * S + c][q]);
          sm.as[0 * BK + q][i] = V::rnd(V::rnd(vp + vn) * V::rnd(sm.rtr[i]));  // TRACK
          sm.as[1 * BK + q][i] = y * sm.single[i];                            // self loop
          sm.as[2 * BK + q][i] = V::rnd(V::rnd(ysum - y) * V::rnd(sm.ron[i]));  // ONSET
          sm.as[3 * BK + q][i] = V::rnd(V::rnd(zsum - z) * V::rnd(sm.rnx[i]));  // NEXT
          sm.as[4 * BK + q][i] = sm.xs[i][q];                                 // root
        }
        __syncthreads();

        // 4. acc += A_chunk @ W_chunk; segment 0 takes the row's own track
        // (bf16: into acct)
#pragma unroll
        for (int seg = 0; seg < NSEG; ++seg) {
          const int blk = seg == 0 ? trk : T - 1 + seg;
#pragma unroll
          for (int q = 0; q < BK; ++q) {
            const float4 a0 = *reinterpret_cast<const float4*>(&sm.as[seg * BK + q][r0]);
            const float4 a1 = *reinterpret_cast<const float4*>(&sm.as[seg * BK + q][r0 + 4]);
            const float4 b0 = *reinterpret_cast<const float4*>(&sm.bs[blk][q][c0]);
            const float4 b1 = *reinterpret_cast<const float4*>(&sm.bs[blk][q][c0 + 64]);
            const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
            if (SPLIT && seg == 0) {
#pragma unroll
              for (int r = 0; r < 8; ++r)
#pragma unroll
                for (int c = 0; c < 8; ++c) acct[r][c] = fmaf(av[r], bv[c], acct[r][c]);
            } else {
#pragma unroll
              for (int r = 0; r < 8; ++r)
#pragma unroll
                for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
            }
          }
        }
        __syncthreads();
      }

      // epilogue: + bias, (bf16: + the track product), * mask, then (EPI)
      // folded batch-norm, relu, * mask, + x
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n0 + c0 + h * 64;
        const float4 bb = V::load4(bias + col);
        const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
        float av[4] = {1.f, 1.f, 1.f, 1.f}, ev[4] = {0.f, 0.f, 0.f, 0.f};
        if (EPI) {
          const float4 aa = V::load4(ea + col);
          const float4 ee = V::load4(eb + col);
          av[0] = aa.x; av[1] = aa.y; av[2] = aa.z; av[3] = aa.w;
          ev[0] = ee.x; ev[1] = ee.y; ev[2] = ee.z; ev[3] = ee.w;
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = r0 + r;
          const float m = sm.m[i];
          float o[4];
          if (EPI) {
            const float4 res = V::load4(xin + (size_t)i * d + col);
            const float rv[4] = {res.x, res.y, res.z, res.w};
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if constexpr (SPLIT) {
                const float v = V::rnd(V::rnd(V::rnd(acc[r][h * 4 + c]) + bv[c])
                                       + V::rnd(acct[r][h * 4 + c])) * m;
                o[c] = fmaxf(V::rnd(V::rnd(v * av[c]) + ev[c]) * m, 0.f) + rv[c];
              } else {
                const float v = (acc[r][h * 4 + c] + bv[c]) * m;
                o[c] = fmaxf((v * av[c] + ev[c]) * m, 0.f) + rv[c];
              }
            }
          } else if constexpr (SPLIT) {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              o[c] = V::rnd(V::rnd(V::rnd(acc[r][h * 4 + c]) + bv[c])
                            + V::rnd(acct[r][h * 4 + c])) * m;
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c) o[c] = (acc[r][h * 4 + c] + bv[c]) * m;
          }
          V::store4(xo + (size_t)i * d + col, make_float4(o[0], o[1], o[2], o[3]));
        }
      }
    }
    // the next layer reads this layer's output rows written by other threads
    __syncthreads();
  }
}

template <typename E, bool EPI>
int launch(const void* x, const void* aux, const void* gates,
           const void* wbigs, const void* biases, const void* eas,
           const void* ebs, void* out, void* scratch, int nbar, int d, int K,
           void* stream) {
  if (nbar <= 0) return 0;
  if (d % BN != 0 || K < 1 || (!EPI && K != 1)) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      gcl_eval_kernel<E, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  gcl_eval_kernel<E, EPI><<<nbar, THREADS, smem, (cudaStream_t)stream>>>(
      (const E*)x, (const int*)aux, (const E*)gates, (const E*)wbigs,
      (const E*)biases, (const E*)eas, (const E*)ebs, (E*)out, (E*)scratch,
      d, K);
  return (int)cudaGetLastError();
}

}  // namespace

// K chained eval layers (folded batch-norm, relu, residual).
extern "C" int gcl_eval_launch(const void* x, const void* aux,
                               const void* gates, const void* wbigs,
                               const void* biases, const void* eas,
                               const void* ebs, void* out, void* scratch,
                               int nbar, int d, int K, void* stream) {
  return launch<float, true>(x, aux, gates, wbigs, biases, eas, ebs, out,
                             scratch, nbar, d, K, stream);
}

// The same K layers with every float tensor in bf16.
extern "C" int gcl_eval_bf16_launch(const void* x, const void* aux,
                                    const void* gates, const void* wbigs,
                                    const void* biases, const void* eas,
                                    const void* ebs, void* out, void* scratch,
                                    int nbar, int d, int K, void* stream) {
  return launch<__nv_bfloat16, true>(x, aux, gates, wbigs, biases, eas, ebs,
                                     out, scratch, nbar, d, K, stream);
}

// One training-forward layer: out = ([h_track | h_self | h_onset | h_next |
// x] @ wbig + bias) * m.
extern "C" int gcl_fwd_launch(const void* x, const void* aux,
                              const void* gates, const void* wbig,
                              const void* bias, void* out, int nbar, int d,
                              void* stream) {
  return launch<float, false>(x, aux, gates, wbig, bias, nullptr, nullptr,
                              out, out, nbar, d, 1, stream);
}

// The same layer with every float tensor in bf16.
extern "C" int gcl_fwd_bf16_launch(const void* x, const void* aux,
                                   const void* gates, const void* wbig,
                                   const void* bias, void* out, int nbar,
                                   int d, void* stream) {
  return launch<__nv_bfloat16, false>(x, aux, gates, wbig, bias, nullptr,
                                      nullptr, out, out, nbar, d, 1, stream);
}
