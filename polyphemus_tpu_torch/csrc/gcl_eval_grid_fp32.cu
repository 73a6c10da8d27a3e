// GCL layers in fp32, on the CUDA cores, for bars of 4 x S cells at any S
// that is a multiple of 4 up to 48 (resolutions 1-12): K chained eval
// layers, or one training-forward layer. At S = 32 the port launches
// `gcl_eval_fp32.cu`, whose CTA is one 128-cell bar; this source takes the
// other grids.
//
// Replaces, in fp32 and at those grids, the Pallas kernels `_kernel_chain`
// (K >= 2, polyphemus_tpu/ops/kernels/gcl_pallas.py:440) and `_kernel` (K =
// 1, gcl_pallas.py:347) with its eval epilogue and without it (the forward
// of the training layer `gcl_fused`, gcl_pallas.py:467-529), which read t,
// s and d from x's shape (`gcl_apply_pallas`, gcl_pallas.py:299-301). Per
// layer and bar of N = 4 S cells it computes what `gcl_eval_fp32.cu`
// computes, cell by cell in the same order of fp32 operations:
//
//   A   = [h_track | h_self | h_onset | h_next | x]            (N x 5d)
//   v   = (A @ [W_t; W0; W_on; W_next; root] + bias) * m
//   out = relu((v * ea + eb) * m) + x          (the eval form, EPI)
//   out = v                                    (the training forward)
//
// with the column-shard form (n of d output columns, K = 1) as there. The
// template flag EPI picks the form (`gcl_eval_grid_launch`,
// `gcl_fwd_grid_launch`), as in `gcl_eval_fp32.cu`.
//
// What bounds it on an H100: operations, as at S = 32: 2 N 5d d flops a bar
// and layer against 2 N d 4 bytes of node state, so a 512-bar launch at K =
// 2 and d = 512 needs 2.57 ms at S = 16 and 7.70 ms at S = 48 at the CUDA
// cores' 67 TFLOP/s. Every 128 rows also stream the layer's 8 d x d weights
// from L2.
//
// Design. The S = 32 kernel's 128 x 256 output pass (a thread 8 rows x 16
// columns, 128 fp32 accumulators; TMA weight stages of 8 features, the A
// chunk of the next stage built while this one multiplies) is kept; what
// changes is which rows a pass holds:
// - A CTA owns `bpc` whole bars (chosen by the launcher, at most 384 cells),
//   so chained layers still meet only at a __syncthreads(), and walks them in
//   row tiles of 128. The rows are padded: each track of a bar takes SP =
//   S rounded up to 8 rows, so the 8 rows of a thread lie in one track and
//   its track block is one weight block, as at S = 32 (the padding rows are
//   never stored). At S = 16 a tile is two bars; at S = 48 two bars are three
//   tiles; at S = 12 a bar is 64 rows, 48 of them cells.
// - The launcher picks bpc to minimise the waves of CTAs times the tiles a
//   CTA walks (and then the tiles in all), so the weight stages amortise
//   over 128 rows where the bars allow it.
// - The statics and each stage's x chunk are kept for every cell of the
//   CTA's bars that the tile touches; the A build takes (bar, column,
//   feature) items over those bars and writes the cells that lie in the
//   tile, with the S = 32 kernel's arithmetic.
#include <cuda.h>

#include "gcl_common.cuh"

namespace {

using gcl::Grid;
using gcl::GridStatics;
using gcl::NBLK;
using gcl::T;

constexpr int THREADS = 256;     // 8 warps
constexpr int BK = 8;            // features per stage
constexpr int NC = 256;          // output columns of a (full) pass
constexpr int NSEG = 5;          // A segments: track, self, onset, next, root
constexpr int MT = 128;          // rows of a tile
constexpr int AP = MT + 4;       // floats per k-row of an A chunk (padded)
constexpr int MAXC = 384;        // cells of a CTA's bars
constexpr int MAXS = 48;         // steps a bar
constexpr int RPAD = 8;          // a track's rows are padded to this multiple

struct Smem : GridStatics<MAXC> {
  unsigned long long wbar[2];             // weight slot s has landed
  alignas(128) float w[2][NBLK * BK * NC];  // a stage's weights [blk][k][NCP]
  alignas(16) float a[2][NSEG][BK][AP];   // A chunk of a tile, k-major
  alignas(16) float xs[2][MAXC][BK];      // x[:, f0:f0+BK] by local cell
  alignas(16) float gs[2][MAXS][BK];      // gate_table[:, f0:f0+BK]
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

// Weight rows f0..f0+BK of the 8 packed blocks of layer blk0 / 8, columns
// n0..n0+NCP: one TMA copy of the box [8 blocks][BK rows][NCP columns],
// completing on `bar`; thread 0 starts it.
template <int NCP>
__device__ __forceinline__ void load_w(float* w, unsigned long long* bar,
                                       const CUtensorMap* map, int f0, int n0,
                                       int blk0) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(NBLK * BK * NCP * 4) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(smem_u32(w)), "l"(reinterpret_cast<unsigned long long>(map)),
        "r"(n0), "r"(f0), "r"(blk0), "r"(smem_u32(bar))
      : "memory");
}

// x[:, f0:f0+BK] of the cells of bars blo..bhi-1 (one 16-byte chunk a
// thread and turn; xin at the CTA's first cell) and gate_table[:, f0:f0+BK]
__device__ __forceinline__ void load_x(float (*xs)[BK], float (*gs)[BK],
                                       const float* xin, const float* gates,
                                       const Grid& gd, int d, int f0,
                                       int tid) {
  const int c0 = gd.blo * gd.N, nchunk = 2 * (gd.bhi - gd.blo) * gd.N;
  for (int j = tid; j < nchunk; j += THREADS) {
    const int c = c0 + (j >> 1), h = (j & 1) * 4;
    cp_async16(&xs[c][h], xin + (size_t)c * d + f0 + h);
  }
  if (tid < 2 * gd.S) {
    const int i = tid >> 1, h = (tid & 1) * 4;
    cp_async16(&gs[i][h], gates + (size_t)i * d + f0 + h);
  }
}

// The five A segments of one stage for the tile at padded row t0. An item
// is feature q of column c of bar b (blo <= b < bhi) in all four tracks
// (cells j = b N + t S + c, tile rows b BP + t SP + c - t0); only the cells
// that lie in the tile are written:
//   track = (relu(x[ps] * g[dp]) * okp + relu(x[ns] * g[dn]) * okn) * rtr
//   self  = y0 * single,              y0 = relu(x * g0) * m
//   onset = (colsum(y0) - y0) * ron
//   next  = (colsum(z) - z) * rnx,    z  = relu(x[pn] * g[dpn]) * okpn
//   root  = x
// colsum sums the four tracks in track order.
__device__ __forceinline__ void build(const Smem& sm, const float (*xs)[BK],
                                      const float (*gs)[BK],
                                      float (*a)[BK][AP], const Grid& gd,
                                      int t0, int tid) {
  const int nitems = (gd.bhi - gd.blo) * gd.S * BK;
  for (int it = tid; it < nitems; it += THREADS) {
    const int q = it & (BK - 1), col = it >> 3;
    const int bq = col / gd.S, c = col - bq * gd.S, b = gd.blo + bq;
    const int base = b * gd.N + c, rbase = b * gd.BP + c - t0;
    const float g0 = gs[0][q];
    float y[T], z[T];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int i = base + t * gd.S, r = rbase + t * gd.SP;
      const float xi = xs[i][q];
      y[t] = fmaxf(xi * g0, 0.f) * sm.m[i];
      z[t] = fmaxf(xs[sm.pn[i]][q] * gs[sm.dpn[i]][q], 0.f) * sm.okpn[i];
      if (r >= 0 && r < MT) {
        const float vp =
            fmaxf(xs[sm.ps[i]][q] * gs[sm.dp[i]][q], 0.f) * sm.okp[i];
        const float vn =
            fmaxf(xs[sm.ns[i]][q] * gs[sm.dn[i]][q], 0.f) * sm.okn[i];
        a[0][q][r] = (vp + vn) * sm.rtr[i];
        a[4][q][r] = xi;
      }
    }
    const float ysum = y[0] + y[1] + y[2] + y[3];
    const float zsum = z[0] + z[1] + z[2] + z[3];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int i = base + t * gd.S, r = rbase + t * gd.SP;
      if (r >= 0 && r < MT) {
        a[1][q][r] = y[t] * sm.single[i];
        a[2][q][r] = (ysum - y[t]) * sm.ron[i];
        a[3][q][r] = (zsum - z[t]) * sm.rnx[i];
      }
    }
  }
}

// acc += A (rows r0..r0+7, one stage) @ W (columns cb + 32 j .. + 3, j < NJ);
// segment 0 takes the block of the thread's own track.
template <int NJ>
__device__ __forceinline__ void gemm_stage(float (&acc)[8][4 * NJ],
                                           const float (*a)[BK][AP],
                                           const float* w, int trk, int r0,
                                           int cb) {
  constexpr int NCP = 64 * NJ;
#pragma unroll 1
  for (int seg = 0; seg < NSEG; ++seg) {
    const float* ap = &a[seg][0][r0];
    const float* wp = w + (seg == 0 ? trk : T - 1 + seg) * BK * NCP + cb;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(ap + k * AP);
      const float4 a1 = *reinterpret_cast<const float4*>(ap + k * AP + 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bv[4 * NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(wp + k * NCP + j * 32);
        bv[4 * j] = b.x; bv[4 * j + 1] = b.y;
        bv[4 * j + 2] = b.z; bv[4 * j + 3] = b.w;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4 * NJ; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
  }
}

// out = relu(((acc + bias) * m * ea + eb) * m) + x (EPI) or out = (acc +
// bias) * m for this thread's cells c0r .. c0r + nrow - 1 (its tile rows r0
// ..) and columns n0 + cb + 32 j .. + 3. Without EPI neither ea, eb nor the
// residual rows are read. out rows are n wide; the residual is xin's column
// c0 + col of rows d wide.
template <int NJ, bool EPI>
__device__ __forceinline__ void epilogue(const Smem& sm,
                                         const float (&acc)[8][4 * NJ],
                                         const float* xin, float* xo,
                                         const float* bias, const float* ea,
                                         const float* eb, int d, int n,
                                         int c0, int n0, int c0r, int nrow,
                                         int cb) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = n0 + cb + j * 32;
    const float4 bb = __ldg(reinterpret_cast<const float4*>(bias + col));
    const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
    if constexpr (!EPI) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (r >= nrow) break;
        const int i = c0r + r;
        const float m = sm.m[i];
        *reinterpret_cast<float4*>(xo + (size_t)i * n + col) = make_float4(
            (acc[r][4 * j] + bv[0]) * m, (acc[r][4 * j + 1] + bv[1]) * m,
            (acc[r][4 * j + 2] + bv[2]) * m, (acc[r][4 * j + 3] + bv[3]) * m);
      }
      continue;
    }
    const float4 aa = __ldg(reinterpret_cast<const float4*>(ea + col));
    const float4 ee = __ldg(reinterpret_cast<const float4*>(eb + col));
    const float av[4] = {aa.x, aa.y, aa.z, aa.w};
    const float ev[4] = {ee.x, ee.y, ee.z, ee.w};
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (r >= nrow) break;
      const int i = c0r + r;
      const float m = sm.m[i];
      float o[4];
      const float4 res =
          __ldcg(reinterpret_cast<const float4*>(xin + (size_t)i * d + c0 + col));
      const float rv[4] = {res.x, res.y, res.z, res.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float v = (acc[r][4 * j + c] + bv[c]) * m;
        o[c] = fmaxf((v * av[c] + ev[c]) * m, 0.f) + rv[c];
      }
      *reinterpret_cast<float4*>(xo + (size_t)i * n + col) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
  }
}

// One pass of one layer over the row tile at t0: columns n0..n0+64 NJ of the
// output, every feature. blk0 is the layer's first block in the tensor map
// (8 k); g counts the stages multiplied so far (weight slot g & 1, mbarrier
// parity (g >> 1) & 1; every pass has an even number of stages).
template <int NJ, bool EPI>
__device__ __forceinline__ void pass(Smem& sm, const float* xin, float* xo,
                                     const float* gates, const CUtensorMap* map,
                                     int blk0, const float* bias,
                                     const float* ea, const float* eb, int d,
                                     int n, int c0, int n0, const Grid& gd,
                                     int t0, int tid, int warp, int trk,
                                     int r0, int c0r, int nrow, int cb,
                                     unsigned& g) {
  constexpr int NCP = 64 * NJ;
  const int nf = d / BK;
  float acc[8][4 * NJ];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4 * NJ; ++c) acc[r][c] = 0.f;

  // prologue: stage 0's weights and x chunk, stage 1's x chunk; build A_0
  if (tid == 0) load_w<NCP>(sm.w[0], &sm.wbar[0], map, 0, n0, blk0);
  load_x(sm.xs[0], sm.gs[0], xin, gates, gd, d, 0, tid);
  cp_async_commit();
  if (nf > 1) load_x(sm.xs[1], sm.gs[1], xin, gates, gd, d, BK, tid);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  build(sm, sm.xs[0], sm.gs[0], sm.a[0], gd, t0, tid);
  cp_async_wait<0>();
  __syncthreads();

  // stage s: A_s and W_s are in; x_{s+1} is in. Fetch W_{s+1} and x_{s+2},
  // build A_{s+1}, multiply stage s, then one barrier.
  for (int s = 0; s < nf; ++s) {
    const int cur = s & 1, nxt = cur ^ 1;
    const bool more = s + 1 < nf;
    if (more && tid == 0)
      load_w<NCP>(sm.w[nxt], &sm.wbar[nxt], map, (s + 1) * BK, n0, blk0);
    if (s + 2 < nf)
      load_x(sm.xs[cur], sm.gs[cur], xin, gates, gd, d, (s + 2) * BK, tid);
    cp_async_commit();
    if (warp < 4 && more)
      build(sm, sm.xs[nxt], sm.gs[nxt], sm.a[nxt], gd, t0, tid);
    mbar_wait(&sm.wbar[cur], (g >> 1) & 1);  // W_s has landed
    ++g;
    gemm_stage<NJ>(acc, sm.a[cur], sm.w[cur], trk, r0, cb);
    if (warp >= 4 && more)
      build(sm, sm.xs[nxt], sm.gs[nxt], sm.a[nxt], gd, t0, tid);
    cp_async_wait<0>();
    __syncthreads();
  }
  epilogue<NJ, EPI>(sm, acc, xin, xo, bias, ea, eb, d, n, c0, n0, c0r, nrow,
                    cb);
}

template <bool EPI>
__global__ void __launch_bounds__(THREADS, 1)
gcl_eval_grid_fp32_kernel(const float* x, const int* aux, const float* gates,
                          const float* biases, const float* eas,
                          const float* ebs, float* out, float* scratch,
                          int nbar, int S, int bpc, int d, int n, int c0,
                          int K,
                          const __grid_constant__ CUtensorMap map256,
                          const __grid_constant__ CUtensorMap map128) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int bar0 = blockIdx.x * bpc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = (warp >> 1) * 32 + (lane >> 3) * 8;  // the thread's 8 rows
  const int half = warp & 1, cx = (lane & 7) * 4;     // and its columns
  Grid gd(S, RPAD, min(bpc, nbar - bar0));
  const int N = gd.N;

  // ---- the statics of the CTA's bars, shared by every layer ----
  gcl::load_grid_statics<float>(sm, aux + (size_t)bar0 * gcl::N_AUX * N,
                                gd.nb, S, tid, THREADS);
  if (tid == 0) {
    mbar_init(&sm.wbar[0]);
    mbar_init(&sm.wbar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  unsigned g = 0;  // stages multiplied so far

  // n < d only at K = 1, so a chained layer's rows are d = n wide
  const size_t bar_off = (size_t)bar0 * N * d, out_off = (size_t)bar0 * N * n;
  for (int k = 0; k < K; ++k) {
    // ping-pong: layer K-1 writes `out`, layer K-2 `scratch`, and so on
    const float* xin = (k == 0) ? x + bar_off
                                : (((K - k) % 2 == 0) ? out : scratch) + out_off;
    float* xo = (((K - 1 - k) % 2 == 0) ? out : scratch) + out_off;
    const float* bias = biases + (size_t)k * n;
    const float* ea = EPI ? eas + (size_t)k * n : nullptr;
    const float* eb = EPI ? ebs + (size_t)k * n : nullptr;
    for (int t0 = 0; t0 < gd.M; t0 += MT) {
      gd.tile(t0, MT);
      // the thread's rows t0 + r0 .. + 7 lie in one track of one bar: its
      // weight block, its first cell and how many of the 8 rows are cells
      const int p = t0 + r0;
      const int b = p / gd.BP, t = (p - b * gd.BP) / gd.SP;
      const int w0 = p - b * gd.BP - t * gd.SP;
      const int trk = p < gd.M ? t : 0;
      const int c0r = b * N + t * S + w0;
      const int nrow = p < gd.M ? min(8, S - w0) : 0;
      int n0 = 0;
      for (; n0 + NC <= n; n0 += NC)
        pass<4, EPI>(sm, xin, xo, gates, &map256, k * NBLK, bias, ea, eb, d,
                     n, c0, n0, gd, t0, tid, warp, trk, r0, c0r, nrow,
                     half * (NC / 2) + cx, g);
      if (n0 < n)  // n % 256 == 128: one pass of 128 columns
        pass<2, EPI>(sm, xin, xo, gates, &map128, k * NBLK, bias, ea, eb, d,
                     n, c0, n0, gd, t0, tid, warp, trk, r0, c0r, nrow,
                     half * (NC / 4) + cx, g);
    }
    // the next layer reads this layer's output rows written by other threads
    __syncthreads();
  }
}

}  // namespace

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime (no
// link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  // the encode needs a current context, which a thread that has made no
  // CUDA call yet lacks (the autograd engine's at its first op: the encode
  // then fails with CUDA_ERROR_INVALID_CONTEXT); cudaSetDevice makes the
  // device's primary context current
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaSetDevice(dev) != cudaSuccess)
    return nullptr;
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The weights of all K layers as a 3-d tensor [8K blocks][d rows][n columns]
// of fp32, read in boxes of [8][BK][ncp].
static bool weight_map(CUtensorMap* map, const void* wbigs, int d, int n,
                       int K, int ncp) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)n, (cuuint64_t)d,
                              (cuuint64_t)NBLK * K};
  const cuuint64_t strides[2] = {(cuuint64_t)n * 4, (cuuint64_t)d * n * 4};
  const cuuint32_t box[3] = {(cuuint32_t)ncp, BK, NBLK};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(wbigs),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The kernel's shared-memory size, set once per device and form.
template <bool EPI>
static cudaError_t allow_smem(int smem) {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(gcl_eval_grid_fp32_kernel<EPI>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

// Bars per CTA for nbar bars of 4 x S cells on `sms` SMs (one CTA each):
// the fewest waves of CTAs times row tiles a CTA, then the fewest tiles in
// all, then the fewest bars a CTA; at most MAXC cells a CTA.
static int bars_per_cta(int nbar, int S, int sms) {
  const int bp = 4 * ((S + RPAD - 1) / RPAD * RPAD);
  long long best_cost = -1, best_work = 0;
  int best = 1;
  for (int bpc = 1; bpc <= nbar && bpc * 4 * S <= MAXC; ++bpc) {
    const long long ctas = (nbar + bpc - 1) / bpc;
    const long long tiles = (bpc * bp + MT - 1) / MT;
    const long long cost = (ctas + sms - 1) / sms * tiles, work = ctas * tiles;
    if (best_cost < 0 || cost < best_cost ||
        (cost == best_cost && work < best_work)) {
      best_cost = cost;
      best_work = work;
      best = bpc;
    }
  }
  return best;
}

// Layers of the kernel's EPI form over bars of 4 x S cells, every float
// tensor fp32: x (nbar, 4 S, d), out, scratch (nbar, 4 S, n), gates (S, d),
// wbigs (K, 8d, n), biases, eas, ebs (K, n); aux (nbar, 14, 4 S) int32. S %
// 4 == 0 up to 48; d % 128 == 0 and n % 128 == 0 with c0 + n <= d; a chain
// (K > 1) takes n = d, c0 = 0. At K = 1 the launch writes output columns
// c0..c0+n-1 of the layer, and scratch may be out. Without EPI, K = 1, c0 =
// 0 and eas, ebs are not read.
template <bool EPI>
static int launch(const void* x, const void* aux, const void* gates,
                  const void* wbigs, const void* biases, const void* eas,
                  const void* ebs, void* out, void* scratch, int nbar, int S,
                  int d, int n, int c0, int K, void* stream) {
  if (nbar <= 0) return 0;
  if (S < 4 || S % 4 != 0 || S > MAXS || d <= 0 || d % 128 != 0 || n <= 0 ||
      n % 128 != 0 || c0 < 0 || c0 % 4 != 0 || c0 + n > d || K < 1 ||
      (!EPI && (K != 1 || c0 != 0)) || (K > 1 && n != d))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = allow_smem<EPI>(smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  // a map for the full 256-column passes and, where n % 256 == 128, one for
  // the last 128-column pass; an unused map stays zero
  CUtensorMap map256 = {}, map128 = {};
  if ((n >= NC && !weight_map(&map256, wbigs, d, n, K, NC)) ||
      (n % NC != 0 && !weight_map(&map128, wbigs, d, n, K, NC / 2)))
    return (int)cudaErrorInvalidValue;
  const int bpc = bars_per_cta(nbar, S, sms);
  gcl_eval_grid_fp32_kernel<EPI>
      <<<(nbar + bpc - 1) / bpc, THREADS, smem, (cudaStream_t)stream>>>(
          (const float*)x, (const int*)aux, (const float*)gates,
          (const float*)biases, (const float*)eas, (const float*)ebs,
          (float*)out, (float*)scratch, nbar, S, bpc, d, n, c0, K, map256,
          map128);
  return (int)cudaGetLastError();
}

// K chained eval layers (folded batch-norm, relu, residual); at K = 1
// output columns c0..c0+n-1 of the layer.
extern "C" int gcl_eval_grid_launch(const void* x, const void* aux,
                                    const void* gates, const void* wbigs,
                                    const void* biases, const void* eas,
                                    const void* ebs, void* out, void* scratch,
                                    int nbar, int S, int d, int n, int c0,
                                    int K, void* stream) {
  return launch<true>(x, aux, gates, wbigs, biases, eas, ebs, out, scratch,
                      nbar, S, d, n, c0, K, stream);
}

// One training-forward layer: out = v, wbig (8d, n), bias (n,), out (nbar,
// 4 S, n).
extern "C" int gcl_fwd_grid_launch(const void* x, const void* aux,
                                   const void* gates, const void* wbig,
                                   const void* bias, void* out, int nbar,
                                   int S, int d, int n, void* stream) {
  return launch<false>(x, aux, gates, wbig, bias, nullptr, nullptr, out, out,
                       nbar, S, d, n, 0, 1, stream);
}

// Dynamic shared memory a CTA takes.
extern "C" int gcl_eval_grid_smem_bytes() { return (int)sizeof(Smem); }
