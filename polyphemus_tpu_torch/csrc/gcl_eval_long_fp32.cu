// One eval GCL layer, or one training-forward layer, in fp32, on the CUDA
// cores, for bars of 4 x S cells at any S that is a multiple of 4 above 48
// (resolutions 13 and up: 24, the Lakh Pianoroll Dataset's grid, is S =
// 96). Up to S = 48 the port launches `gcl_eval_grid_fp32.cu`, whose CTA
// owns whole bars; above that one bar no longer fits a CTA's shared memory,
// and this source takes the bar in tiles.
//
// Replaces, in fp32 and at those grids, the Pallas kernels `_kernel` (K =
// 1, polyphemus_tpu/ops/kernels/gcl_pallas.py:347) with its eval epilogue
// and without it (the forward of the custom VJP `gcl_fused`,
// gcl_pallas.py:466-467), and `_kernel_chain` (K >= 2, gcl_pallas.py:440),
// which read t, s and d from x's shape (`gcl_apply_pallas`,
// gcl_pallas.py:299-301). A chain is the same function as its layers one
// after the other: the wrapper (`ops/kernels/gcl.py::gcl_eval`) launches
// this kernel once a layer. Per bar of N = 4 S cells it computes what
// `gcl_eval_grid_fp32.cu` computes, cell by cell in the same order of fp32
// operations:
//
//   A   = [h_track | h_self | h_onset | h_next | x]            (N x 5d)
//   v   = (A @ [W_t; W0; W_on; W_next; root] + bias) * m
//   out = relu((v * ea + eb) * m) + x          (the eval form, EPI)
//   out = v                                    (the training forward)
//
// The template flag EPI picks the form (`gcl_eval_long_launch`,
// `gcl_fwd_long_launch`), as in `gcl_eval_grid_fp32.cu`. Either form takes
// the column form of tensor parallelism: wbig (8d, n) holds n of the d
// output columns (n % 128 == 0), bias, ea and eb their n entries, and the
// launch writes those n columns, the eval form's residual being x's columns
// c0 .. c0 + n - 1; the gathered source rows keep all d input features.
//
// What bounds it on an H100: operations, 2 N 5d d flops a bar against 2 N
// d 4 bytes of node state, so a 512-bar layer at d = 512 needs 7.70 ms at S
// = 96 at the CUDA cores' 67 TFLOP/s.
//
// Design. The grid kernel's 128 x 256 output pass (a thread 8 rows x 16
// columns, 128 fp32 accumulators; TMA weight stages of 8 features, the A
// chunk of the next stage built while this one multiplies) is kept; what
// changes is which cells a CTA holds and where it reads their sources:
// - A CTA owns one tile of one bar: the 4 tracks x 32 columns of columns c0
//   .. c0 + 31 (the last tile of a bar holds S % 32 columns, the rows past
//   the bar computed and never stored). Row r = 32 t + cc is cell (t, c0 +
//   cc), so the 8 rows of a thread lie in one track (one weight block), and
//   the four cells of a column, whose sums the onset and next segments
//   take, lie in the tile.
// - It keeps the statics of its own 128 cells (`gcl::TileStatics`). The
//   rows that a cell reads (itself, the previous and the next active cell
//   of its track, its track's cell in the previous active column) may lie
//   anywhere in the bar: each stage gathers those four rows' 8 features per
//   cell from device memory (L2) by cp.async, two stages ahead, as the grid
//   kernel stages its bars' x. The gate rows are read by distance from the
//   gate table (S x d, L1/L2-resident) with __ldg.
// - No size depends on S: a bar of any length is ceil(S / 32) CTAs.
// - The output passes run over the n columns of the launch: n / 256 passes
//   of 256 columns, then one of 128 where n % 256 == 128.
#include <cuda.h>

#include "gcl_common.cuh"

namespace {

using gcl::NBLK;
using gcl::T;

constexpr int THREADS = 256;     // 8 warps
constexpr int BK = 8;            // features per stage
constexpr int NC = 256;          // output columns of a (full) pass
constexpr int NSEG = 5;          // A segments: track, self, onset, next, root
constexpr int CW = 32;           // bar columns of a tile
constexpr int MT = T * CW;       // rows of a tile
constexpr int AP = MT + 4;       // floats per k-row of an A chunk (padded)
constexpr int NSRC = 4;          // gathered rows a cell: self, prev, next, pn

struct Smem : gcl::TileStatics<CW> {
  unsigned long long wbar[2];             // weight slot s has landed
  alignas(128) float w[2][NBLK * BK * NC];  // a stage's weights [blk][k][NCP]
  alignas(16) float a[2][NSEG][BK][AP];   // A chunk of the tile, k-major
  alignas(16) float xs[2][NSRC][MT][BK];  // x[src, f0:f0+BK] by source, row
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

// Weight rows f0..f0+BK of the 8 packed blocks, columns n0..n0+NCP: one TMA
// copy of the box [8 blocks][BK rows][NCP columns], completing on `bar`;
// thread 0 starts it.
template <int NCP>
__device__ __forceinline__ void load_w(float* w, unsigned long long* bar,
                                       const CUtensorMap* map, int f0,
                                       int n0) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(NBLK * BK * NCP * 4) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(smem_u32(w)), "l"(reinterpret_cast<unsigned long long>(map)),
        "r"(n0), "r"(f0), "r"(0), "r"(smem_u32(bar))
      : "memory");
}

// x[src, f0:f0+BK] of the NSRC source cells of every row of the tile (xb at
// the bar's first cell), one 16-byte chunk a thread and turn
__device__ __forceinline__ void load_x(float (*xs)[MT][BK], const Smem& sm,
                                       const float* xb, int d, int f0,
                                       int tid) {
  for (int j = tid; j < NSRC * MT * 2; j += THREADS) {
    const int h = (j & 1) * 4, r = (j >> 1) % MT, src = (j >> 1) / MT;
    cp_async16(&xs[src][r][h], xb + (size_t)sm.src[src][r] * d + f0 + h);
  }
}

// The five A segments of one stage. An item is feature q of column cc of
// the tile in all four tracks (rows r = 32 t + cc):
//   track = (relu(x[ps] * g[dp]) * okp + relu(x[ns] * g[dn]) * okn) * rtr
//   self  = y0 * single,              y0 = relu(x * g0) * m
//   onset = (colsum(y0) - y0) * ron
//   next  = (colsum(z) - z) * rnx,    z  = relu(x[pn] * g[dpn]) * okpn
//   root  = x
// colsum sums the four tracks in track order; g is gates[:, f0:f0+BK].
__device__ __forceinline__ void build(const Smem& sm,
                                      const float (*xs)[MT][BK],
                                      float (*a)[BK][AP], const float* gates,
                                      int d, int f0, int tid) {
  for (int it = tid; it < CW * BK; it += THREADS) {
    const int q = it & (BK - 1), cc = it >> 3;
    const float* g = gates + f0 + q;
    const float g0 = __ldg(g);
    float y[T], z[T];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int r = t * CW + cc;
      const float xi = xs[0][r][q];
      y[t] = fmaxf(xi * g0, 0.f) * sm.m[r];
      z[t] = fmaxf(xs[3][r][q] * __ldg(g + (size_t)sm.dpn[r] * d), 0.f) *
             sm.okpn[r];
      const float vp =
          fmaxf(xs[1][r][q] * __ldg(g + (size_t)sm.dp[r] * d), 0.f) * sm.okp[r];
      const float vn =
          fmaxf(xs[2][r][q] * __ldg(g + (size_t)sm.dn[r] * d), 0.f) * sm.okn[r];
      a[0][q][r] = (vp + vn) * sm.rtr[r];
      a[4][q][r] = xi;
    }
    const float ysum = y[0] + y[1] + y[2] + y[3];
    const float zsum = z[0] + z[1] + z[2] + z[3];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int r = t * CW + cc;
      a[1][q][r] = y[t] * sm.single[r];
      a[2][q][r] = (ysum - y[t]) * sm.ron[r];
      a[3][q][r] = (zsum - z[t]) * sm.rnx[r];
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
// bias) * m for this thread's rows r0 .. r0 + nrow - 1 (the bar's cells c0r
// ..; xb, ob at the bar's first cell; x rows d wide, out rows n) and output
// columns n0 + cb + 32 j .. + 3, x's columns oc0 on. Without EPI neither
// ea, eb nor x is read.
template <int NJ, bool EPI>
__device__ __forceinline__ void epilogue(const Smem& sm,
                                         const float (&acc)[8][4 * NJ],
                                         const float* xb, float* ob,
                                         const float* bias, const float* ea,
                                         const float* eb, int d, int n,
                                         int oc0, int n0, int r0, int c0r,
                                         int nrow, int cb) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = n0 + cb + j * 32;
    const float4 bb = __ldg(reinterpret_cast<const float4*>(bias + col));
    const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
    if constexpr (!EPI) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (r >= nrow) break;
        const float m = sm.m[r0 + r];
        float o[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) o[c] = (acc[r][4 * j + c] + bv[c]) * m;
        *reinterpret_cast<float4*>(ob + (size_t)(c0r + r) * n + col) =
            make_float4(o[0], o[1], o[2], o[3]);
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
      const size_t i = (size_t)(c0r + r) * n + col;
      const float m = sm.m[r0 + r];
      const float4 res = __ldcg(reinterpret_cast<const float4*>(
          xb + (size_t)(c0r + r) * d + oc0 + col));
      const float rv[4] = {res.x, res.y, res.z, res.w};
      float o[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float v = (acc[r][4 * j + c] + bv[c]) * m;
        o[c] = fmaxf((v * av[c] + ev[c]) * m, 0.f) + rv[c];
      }
      *reinterpret_cast<float4*>(ob + i) = make_float4(o[0], o[1], o[2], o[3]);
    }
  }
}

// One pass over the tile: columns n0..n0+64 NJ of the output, every
// feature. g counts the stages multiplied so far (weight slot g & 1,
// mbarrier parity (g >> 1) & 1; every pass has an even number of stages).
template <int NJ, bool EPI>
__device__ __forceinline__ void pass(Smem& sm, const float* xb, float* ob,
                                     const float* gates, const CUtensorMap* map,
                                     const float* bias, const float* ea,
                                     const float* eb, int d, int n, int oc0,
                                     int n0, int tid,
                                     int warp, int trk, int r0, int c0r,
                                     int nrow, int cb, unsigned& g) {
  constexpr int NCP = 64 * NJ;
  const int nf = d / BK;
  float acc[8][4 * NJ];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4 * NJ; ++c) acc[r][c] = 0.f;

  // prologue: stage 0's weights and x rows, stage 1's x rows; build A_0
  if (tid == 0) load_w<NCP>(sm.w[0], &sm.wbar[0], map, 0, n0);
  load_x(sm.xs[0], sm, xb, d, 0, tid);
  cp_async_commit();
  if (nf > 1) load_x(sm.xs[1], sm, xb, d, BK, tid);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  build(sm, sm.xs[0], sm.a[0], gates, d, 0, tid);
  cp_async_wait<0>();
  __syncthreads();

  // stage s: A_s and W_s are in; x_{s+1} is in. Fetch W_{s+1} and x_{s+2},
  // build A_{s+1}, multiply stage s, then one barrier.
  for (int s = 0; s < nf; ++s) {
    const int cur = s & 1, nxt = cur ^ 1;
    const bool more = s + 1 < nf;
    if (more && tid == 0)
      load_w<NCP>(sm.w[nxt], &sm.wbar[nxt], map, (s + 1) * BK, n0);
    if (s + 2 < nf) load_x(sm.xs[cur], sm, xb, d, (s + 2) * BK, tid);
    cp_async_commit();
    if (warp < 4 && more)
      build(sm, sm.xs[nxt], sm.a[nxt], gates, d, (s + 1) * BK, tid);
    mbar_wait(&sm.wbar[cur], (g >> 1) & 1);  // W_s has landed
    ++g;
    gemm_stage<NJ>(acc, sm.a[cur], sm.w[cur], trk, r0, cb);
    if (warp >= 4 && more)
      build(sm, sm.xs[nxt], sm.a[nxt], gates, d, (s + 1) * BK, tid);
    cp_async_wait<0>();
    __syncthreads();
  }
  epilogue<NJ, EPI>(sm, acc, xb, ob, bias, ea, eb, d, n, oc0, n0, r0, c0r,
                    nrow, cb);
}

template <bool EPI>
__global__ void __launch_bounds__(THREADS, 1)
gcl_eval_long_fp32_kernel(const float* x, const int* aux, const float* gates,
                          const float* bias, const float* ea, const float* eb,
                          float* out, int S, int d, int n, int oc0,
                          const __grid_constant__ CUtensorMap map256,
                          const __grid_constant__ CUtensorMap map128) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int ntile = (S + CW - 1) / CW, N = T * S;
  const int bar = blockIdx.x / ntile, c0 = (blockIdx.x % ntile) * CW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the thread's 8 rows (one track) and its columns
  const int r0 = (warp >> 1) * 32 + (lane >> 3) * 8;
  const int half = warp & 1, cx = (lane & 7) * 4;
  const int trk = r0 / CW, w0 = c0 + r0 % CW;
  const int c0r = trk * S + w0, nrow = max(0, min(8, S - w0));

  gcl::load_tile_statics<float, CW>(sm, aux + (size_t)bar * gcl::N_AUX * N,
                                    S, c0, tid, THREADS);
  if (tid == 0) {
    mbar_init(&sm.wbar[0]);
    mbar_init(&sm.wbar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  unsigned g = 0;  // stages multiplied so far

  const float* xb = x + (size_t)bar * N * d;
  float* ob = out + (size_t)bar * N * n;
  int n0 = 0;
  for (; n0 + NC <= n; n0 += NC)
    pass<4, EPI>(sm, xb, ob, gates, &map256, bias, ea, eb, d, n, oc0, n0, tid,
                 warp, trk, r0, c0r, nrow, half * (NC / 2) + cx, g);
  if (n0 < n)  // n % 256 == 128: one pass of 128 columns
    pass<2, EPI>(sm, xb, ob, gates, &map128, bias, ea, eb, d, n, oc0, n0, tid,
                 warp, trk, r0, c0r, nrow, half * (NC / 4) + cx, g);
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

// The layer's weights as a 3-d tensor [8 blocks][d rows][n columns] of
// fp32, read in boxes of [8][BK][ncp].
static bool weight_map(CUtensorMap* map, const void* wbig, int d, int n,
                       int ncp) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)n, (cuuint64_t)d, (cuuint64_t)NBLK};
  const cuuint64_t strides[2] = {(cuuint64_t)n * 4, (cuuint64_t)d * n * 4};
  const cuuint32_t box[3] = {(cuuint32_t)ncp, BK, NBLK};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(wbig),
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
  err = cudaFuncSetAttribute(gcl_eval_long_fp32_kernel<EPI>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

// One layer of the kernel's EPI form over bars of 4 x S cells, every float
// tensor fp32: x (nbar, 4 S, d), out (nbar, 4 S, n), gates (S, d), wbig
// (8d, n), bias, ea, eb (n,) (without EPI ea and eb are not read); aux
// (nbar, 14, 4 S) int32. S % 4 == 0, S > 0; d % 128 == 0 and n % 128 == 0
// with c0 + n <= d, c0 the first output column (x's residual columns);
// without EPI c0 = 0. The CTAs (nbar ceil(S / 32)) and every cell, feature
// and aux index within int32.
template <bool EPI>
static int launch(const void* x, const void* aux, const void* gates,
                  const void* wbig, const void* bias, const void* ea,
                  const void* eb, void* out, int nbar, int S, int d, int n,
                  int c0, void* stream) {
  if (nbar <= 0) return 0;
  const long long ctas = (long long)nbar * ((S + CW - 1) / CW);
  if (S < 4 || S % 4 != 0 || d <= 0 || d % 128 != 0 || n <= 0 ||
      n % 128 != 0 || c0 < 0 || c0 % 4 != 0 || c0 + n > d ||
      (!EPI && c0 != 0) ||
      ctas > 0x7fffffffLL || (long long)S * d > 0x7fffffffLL ||
      (long long)gcl::N_AUX * T * S > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = allow_smem<EPI>(smem);
  if (err != cudaSuccess) return (int)err;
  // a map for the full 256-column passes and, where n % 256 == 128, one for
  // the last 128-column pass; an unused map stays zero
  CUtensorMap map256 = {}, map128 = {};
  if ((n >= NC && !weight_map(&map256, wbig, d, n, NC)) ||
      (n % NC != 0 && !weight_map(&map128, wbig, d, n, NC / 2)))
    return (int)cudaErrorInvalidValue;
  gcl_eval_long_fp32_kernel<EPI><<<(unsigned)ctas, THREADS, smem,
                                   (cudaStream_t)stream>>>(
      (const float*)x, (const int*)aux, (const float*)gates,
      (const float*)bias, (const float*)ea, (const float*)eb, (float*)out, S,
      d, n, c0, map256, map128);
  return (int)cudaGetLastError();
}

// One eval layer (folded batch-norm, relu, residual): output columns c0 ..
// c0 + n - 1 of the layer; see `launch`.
extern "C" int gcl_eval_long_launch(const void* x, const void* aux,
                                    const void* gates, const void* wbig,
                                    const void* bias, const void* ea,
                                    const void* eb, void* out, int nbar,
                                    int S, int d, int n, int c0,
                                    void* stream) {
  return launch<true>(x, aux, gates, wbig, bias, ea, eb, out, nbar, S, d, n,
                      c0, stream);
}

// One training-forward layer, out = (gcl(x) + bias) * m: wbig (8d, n),
// bias (n,), out (nbar, 4 S, n); see `launch`.
extern "C" int gcl_fwd_long_launch(const void* x, const void* aux,
                                   const void* gates, const void* wbig,
                                   const void* bias, void* out, int nbar,
                                   int S, int d, int n, void* stream) {
  return launch<false>(x, aux, gates, wbig, bias, nullptr, nullptr, out,
                       nbar, S, d, n, 0, stream);
}

// Dynamic shared memory a CTA takes.
extern "C" int gcl_eval_long_smem_bytes() { return (int)sizeof(Smem); }
