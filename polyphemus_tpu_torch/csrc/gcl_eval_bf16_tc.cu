// GCL layers in bf16, on the tensor cores: K chained eval layers, or one
// training-forward layer.
//
// Replaces, in bf16, the Pallas kernels `_kernel_chain` (K >= 2,
// polyphemus_tpu/ops/kernels/gcl_pallas.py:440) and `_kernel` (K = 1,
// gcl_pallas.py:347) with its eval epilogue and without it, reached through
// `gcl_apply_pallas_chain`, `gcl_apply_pallas(..., epilogue_affine=...)` and
// the forward of the training custom VJP `gcl_fused`. Per layer and bar of
// n = 4 x 32 cells it computes what the bf16 Pallas body computes, with rnd
// the rounding to bf16:
//
//   base = rnd(rnd([h_self | h_onset | h_next | x] @ [W0; W_on; W_next; root])
//              + bias)
//   v    = rnd(base + rnd(h_track @ W_t)) * m      (W_t: the row's own track)
//   out  = rnd(relu(rnd(rnd(v * ea) + eb) * m) + x)   (eval)
//   out  = v                                         (training forward)
//
// The template flag EPI picks the form (`gcl_eval_bf16_launch`,
// `gcl_fwd_bf16_launch`); only the stores of a tile's last stage differ.
// The weights may hold only n of the d output columns (a column shard under
// tensor parallelism, n % 128 == 0, K = 1): then `out` is those n columns,
// (nbar, 128, n), and the eval epilogue's residual reads x's columns
// c0..c0+n-1. The A build stays over all d input features.
//
// The message segments round where the Pallas body casts: each elementwise
// product, the mean reciprocals, the same-column sums and each segment, so
// every segment is a bf16 value. The products take bf16 operands and sum in
// fp32 on the tensor cores (mma.sync m16n8k16, bf16 -> fp32): only the
// summation order differs from the plain versions (`gcl.gcl_eval_plain`,
// `gcl.gcl_fwd_plain`).
//
// What bounds it on an H100: operations. Per bar and layer the products are
// 2 * 128 * 5d * d flops (335 MFLOP at d = 512) against 2 * 128 * d * 2
// bytes of node state; at 989 TFLOP/s of bf16 tensor-core rate a 512-bar
// launch at K = 2 needs 0.35 ms, a 256-bar training forward 0.087 ms (one
// wave at two CTAs per SM). Every bar also reads the layer's 8d x d weights
// (4 MB at d = 512) from L2.
//
// Design, one CTA of 8 warps per bar, two CTAs per SM (92 KB of shared
// memory, at most 128 registers a thread):
// - Output tiles of 128 rows x 128 columns. Each warp owns 32 rows (one
//   track) x 64 columns: 64 fp32 accumulators a thread.
// - Per tile, two passes over the features in stages of 16. First the track
//   product: each warp multiplies its rows by its own track's block. Its
//   result is rounded and parked in shared memory, and the same accumulators
//   then take the 4d-deep product of the shared segments. No second
//   accumulator tile stays live.
// - Each stage's weight tile (4 blocks x 16 rows x 128 columns, 16 KB of
//   bf16) comes in by cp.async, double-buffered: the next stage's weights
//   arrive while this stage builds its A chunk and multiplies. The next x
//   and gate chunk arrive during the products.
// - A is built in bf16 shared memory from a bf16 tile of x[:, f0:f0+16] and
//   the gate rows: no fp32 staging. One thread computes a column's four y0
//   (or NEXT-source) messages and writes the self and onset (or next)
//   segments from them, so a build needs one barrier.
// - Fragments come from ldmatrix (.trans for the row-major weight tiles);
//   the weight and A tiles are XOR-swizzled against bank conflicts.
// - The per-bar statics stay in shared memory for all K layers; between
//   chained layers the bar's state goes through a per-bar ping-pong buffer
//   in device memory (it stays in L2).
// Still open: every output tile rebuilds the message segments (d / 128
// times per layer), and each bar streams the weights from L2 on its own.
#include <stdint.h>

#include "gcl_common.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace gcl;
using namespace tc;

constexpr int THREADS = 256;     // 8 warps
constexpr int BN = 128;          // output columns per tile
constexpr int BK = 16;           // features per stage: one MMA k-step
constexpr int NSB = 4;           // weight blocks per stage (tracks, or shared)
constexpr int WROWS = NSB * BK;  // weight rows per stage
constexpr int NPARK = 32;        // parked bf16 pairs per thread

struct Smem : Statics {
  alignas(16) bf16 w[2][WROWS * BN];      // weight tiles [row][col], swizzled
  alignas(16) bf16 a[NSB][N * BK];        // A chunk per segment [row][k], swizzled
  alignas(16) bf16 xs[N * BK];            // x[:, f0:f0+BK]
  alignas(16) bf16 gs[S * BK];            // gate_table[:, f0:f0+BK]
  alignas(16) uint32_t park[NPARK][THREADS];  // rounded track product
};

__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Element offsets of 8-element chunk `ch` of row r. Weight tile: 16 chunks
// a row, chunk ch stored at ch ^ (r % 8). A chunk: 2 chunks a row, stored
// at ch ^ ((r / 4) % 2). An 8-row ldmatrix then touches 8 distinct
// 16-byte bank groups.
__device__ __forceinline__ int w_off(int r, int ch) {
  return r * BN + ((ch ^ (r & 7)) << 3);
}

__device__ __forceinline__ int a_off(int r, int ch) {
  return r * BK + ((ch ^ ((r >> 2) & 1)) << 3);
}

// Weight tile of one stage: row b * BK + kk is row f0 + kk of packed block
// blk0 + b (rows n wide), columns n0 .. n0 + BN.
__device__ __forceinline__ void load_w(bf16* dst, const bf16* W, int d,
                                       int n, int blk0, int f0, int n0,
                                       int tid) {
#pragma unroll
  for (int j = 0; j < WROWS * BN / 8 / THREADS; ++j) {
    const int c = tid + j * THREADS;
    const int r = c >> 4, ch = c & 15;
    const int blk = blk0 + r / BK, kk = r % BK;
    cp_async16(dst + w_off(r, ch),
               W + ((size_t)blk * d + f0 + kk) * n + n0 + ch * 8);
  }
}

// x[:, f0:f0+BK] (one 16-byte chunk a thread) and gate_table[:, f0:f0+BK]
__device__ __forceinline__ void load_x(Smem& sm, const bf16* xin,
                                       const bf16* gates, int d, int f0,
                                       int tid) {
  const int i = tid >> 1, h = tid & 1;
  cp_async16(sm.xs + i * BK + h * 8, xin + (size_t)i * d + f0 + h * 8);
  if (tid < 2 * S)
    cp_async16(sm.gs + i * BK + h * 8, gates + (size_t)i * d + f0 + h * 8);
}

// TRACK segment: rnd(rnd(vp + vn) * rtr), vp = relu(rnd(x[ps] * g[dp])) *
// okp and vn alike; thread tid builds features 8h..8h+7 of cell tid / 2.
__device__ __forceinline__ void build_track(Smem& sm, int tid) {
  const int i = tid >> 1, h = tid & 1;
  const uint4 xp = *reinterpret_cast<const uint4*>(sm.xs + sm.ps[i] * BK + h * 8);
  const uint4 gp = *reinterpret_cast<const uint4*>(sm.gs + sm.dp[i] * BK + h * 8);
  const uint4 xn = *reinterpret_cast<const uint4*>(sm.xs + sm.ns[i] * BK + h * 8);
  const uint4 gn = *reinterpret_cast<const uint4*>(sm.gs + sm.dn[i] * BK + h * 8);
  const uint32_t uxp[4] = {xp.x, xp.y, xp.z, xp.w};
  const uint32_t ugp[4] = {gp.x, gp.y, gp.z, gp.w};
  const uint32_t uxn[4] = {xn.x, xn.y, xn.z, xn.w};
  const uint32_t ugn[4] = {gn.x, gn.y, gn.z, gn.w};
  const float okp = sm.okp[i], okn = sm.okn[i], rtr = sm.rtr[i];
  uint32_t o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 a = bf2(uxp[e]), b = bf2(ugp[e]);
    const float2 c = bf2(uxn[e]), g = bf2(ugn[e]);
    const float p0 = fmaxf(rnd(a.x * b.x), 0.f) * okp;
    const float p1 = fmaxf(rnd(a.y * b.y), 0.f) * okp;
    const float n0 = fmaxf(rnd(c.x * g.x), 0.f) * okn;
    const float n1 = fmaxf(rnd(c.y * g.y), 0.f) * okn;
    o[e] = pack2(rnd(p0 + n0) * rtr, rnd(p1 + n1) * rtr);
  }
  *reinterpret_cast<uint4*>(sm.a[0] + a_off(i, h)) =
      make_uint4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ void load4(float (&v)[4], const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = bf2(u.x), hi = bf2(u.y);
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
}

// The shared segments: self, onset, next, root (A segments 0-3). Warps 0-3
// take y0 = relu(rnd(x * g0)) * m -> self = y0 * single and onset =
// rnd(rnd(colsum(y0) - y0) * ron); warps 4-7 take the NEXT-source messages
// z = relu(rnd(x[pn] * g[dpn])) * okpn -> next = rnd(rnd(colsum(z) - z) *
// rnx). A thread covers features q0..q0+3 of one column c in all 4 tracks;
// colsum rounds the fp32 sum over the tracks, in track order.
__device__ __forceinline__ void build_shared(Smem& sm, int tid) {
  {
    const int i = tid >> 1, h = tid & 1;  // root: x itself
    *reinterpret_cast<uint4*>(sm.a[3] + a_off(i, h)) =
        *reinterpret_cast<const uint4*>(sm.xs + i * BK + h * 8);
  }
  const int c = (tid >> 2) & (S - 1), q0 = (tid & 3) * 4;
  const int ch = q0 >> 3, sub = q0 & 7;
  float v[T][4], sum[4];
  if (tid < THREADS / 2) {
    float g0[4];
    load4(g0, sm.gs + q0);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int i = t * S + c;
      float xv[4];
      load4(xv, sm.xs + i * BK + q0);
      const float m = sm.m[i];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[t][e] = fmaxf(rnd(xv[e] * g0[e]), 0.f) * m;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[e] = rnd(v[0][e] + v[1][e] + v[2][e] + v[3][e]);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int i = t * S + c;
      const float single = sm.single[i], ron = sm.ron[i];
      float self[4], onset[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        self[e] = v[t][e] * single;
        onset[e] = rnd(rnd(sum[e] - v[t][e]) * ron);
      }
      store4(sm.a[0] + a_off(i, ch) + sub, self);
      store4(sm.a[1] + a_off(i, ch) + sub, onset);
    }
  } else {
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int i = t * S + c;
      float xv[4], gv[4];
      load4(xv, sm.xs + sm.pn[i] * BK + q0);
      load4(gv, sm.gs + sm.dpn[i] * BK + q0);
      const float ok = sm.okpn[i];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[t][e] = fmaxf(rnd(xv[e] * gv[e]), 0.f) * ok;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[e] = rnd(v[0][e] + v[1][e] + v[2][e] + v[3][e]);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int i = t * S + c;
      const float rnx = sm.rnx[i];
      float nx[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) nx[e] = rnd(rnd(sum[e] - v[t][e]) * rnx);
      store4(sm.a[2] + a_off(i, ch) + sub, nx);
    }
  }
}

// acc += A rows row0..row0+31 (16 features of one segment) @ weight-tile
// rows wrow..wrow+15, columns col0..col0+63: 16 MMAs a warp.
__device__ __forceinline__ void mma_k16(float (&acc)[2][8][4], const bf16* a,
                                        const bf16* w, int wrow, int row0,
                                        int col0, int lane) {
  uint32_t af[2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
    ldsm_x4(af[mi], a + a_off(row0 + mi * 16 + (lane & 15), lane >> 4));
  const int r = wrow + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int jp = 0; jp < 4; ++jp) {
    uint32_t b[4];
    ldsm_x4_t(b, w + w_off(r, ((col0 + jp * 16) >> 3) + (lane >> 4)));
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      mma_bf16(acc[mi][2 * jp], af[mi], b[0], b[1]);
      mma_bf16(acc[mi][2 * jp + 1], af[mi], b[2], b[3]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[2][8][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
}

// Accumulator element (mi, nj, e) of lane l sits at row row0 + 16 mi + l / 4
// + 8 (e / 2), column col0 + 8 nj + 2 (l % 4) + e % 2; its bf16 pair
// (e = 0, 1 or 2, 3) is parked at park[16 mi + 2 nj + e / 2][tid].
__device__ __forceinline__ void park_track(Smem& sm, float (&acc)[2][8][4],
                                           int tid) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        sm.park[mi * 16 + nj * 2 + hh][tid] =
            pack2(acc[mi][nj][2 * hh], acc[mi][nj][2 * hh + 1]);
}

// out = rnd(relu(rnd(rnd(v * ea) + eb) * m) + x) (EPI) or out = v, v =
// rnd(rnd(rnd(acc) + bias) + track) * m, for this thread's accumulators of
// tile n0. Without EPI neither ea, eb nor the residual rows are read. out
// rows are n wide; the residual is xin's column c0 + col of rows d wide.
template <bool EPI>
__device__ __forceinline__ void epilogue(const Smem& sm,
                                         const float (&acc)[2][8][4],
                                         const bf16* xin, bf16* xo,
                                         const bf16* bias, const bf16* ea,
                                         const bf16* eb, int d, int n, int c0,
                                         int n0, int row0, int col0, int tid) {
  const int lane = tid & 31;
#pragma unroll
  for (int nj = 0; nj < 8; ++nj) {
    const int col = n0 + col0 + nj * 8 + 2 * (lane & 3);
    const float2 bb = bf2(*reinterpret_cast<const uint32_t*>(bias + col));
    if constexpr (!EPI) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = row0 + mi * 16 + (lane >> 2) + hh * 8;
          const float m = sm.m[row];
          const float2 tk = bf2(sm.park[mi * 16 + nj * 2 + hh][tid]);
          const float v0 = rnd(rnd(rnd(acc[mi][nj][2 * hh]) + bb.x) + tk.x) * m;
          const float v1 = rnd(rnd(rnd(acc[mi][nj][2 * hh + 1]) + bb.y) + tk.y) * m;
          *reinterpret_cast<uint32_t*>(xo + (size_t)row * n + col) = pack2(v0, v1);
        }
    } else {
      const float2 aa = bf2(*reinterpret_cast<const uint32_t*>(ea + col));
      const float2 ee = bf2(*reinterpret_cast<const uint32_t*>(eb + col));
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = row0 + mi * 16 + (lane >> 2) + hh * 8;
          const float m = sm.m[row];
          const float2 tk = bf2(sm.park[mi * 16 + nj * 2 + hh][tid]);
          const float2 xr =
              bf2(*reinterpret_cast<const uint32_t*>(xin + (size_t)row * d + c0 + col));
          const float v0 = rnd(rnd(rnd(acc[mi][nj][2 * hh]) + bb.x) + tk.x) * m;
          const float v1 = rnd(rnd(rnd(acc[mi][nj][2 * hh + 1]) + bb.y) + tk.y) * m;
          const float o0 = fmaxf(rnd(rnd(v0 * aa.x) + ee.x) * m, 0.f) + xr.x;
          const float o1 = fmaxf(rnd(rnd(v1 * aa.y) + ee.y) * m, 0.f) + xr.y;
          *reinterpret_cast<uint32_t*>(xo + (size_t)row * n + col) = pack2(o0, o1);
        }
    }
  }
}

template <bool EPI>
__global__ void __launch_bounds__(THREADS, 2)
gcl_eval_bf16_tc_kernel(const bf16* x, const int* aux, const bf16* gates,
                        const bf16* wbigs, const bf16* biases, const bf16* eas,
                        const bf16* ebs, bf16* out, bf16* scratch, int d,
                        int n, int c0, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int bar = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int trk = warp >> 1;          // the warp's rows are track trk's
  const int row0 = trk * S;
  const int col0 = (warp & 1) * 64;   // and these 64 columns of each tile

  // ---- per-bar statics, shared by every layer of the launch ----
  load_statics(sm, aux + (size_t)bar * N_AUX * N, tid, THREADS);
  if (tid < N) {  // cell tid was decoded by this thread; the body rounds these
    sm.rtr[tid] = rnd(sm.rtr[tid]);
    sm.ron[tid] = rnd(sm.ron[tid]);
    sm.rnx[tid] = rnd(sm.rnx[tid]);
  }
  __syncthreads();

  // Stages of a layer: per output tile, nf stages of the track product
  // (weight blocks 0-3) and then nf of the shared product (blocks 4-7).
  const int nf = d / BK;
  const int per_tile = 2 * nf;
  const int nstage = (n / BN) * per_tile;
  // n < d only at K = 1, so a chained layer's rows are d = n wide
  const size_t bar_off = (size_t)bar * N * d, out_off = (size_t)bar * N * n;

  for (int k = 0; k < K; ++k) {
    // ping-pong: layer K-1 writes `out`, layer K-2 `scratch`, and so on
    const bf16* xin = (k == 0) ? x + bar_off
                               : (((K - k) % 2 == 0) ? out : scratch) + out_off;
    bf16* xo = (((K - 1 - k) % 2 == 0) ? out : scratch) + out_off;
    const bf16* W = wbigs + (size_t)k * NBLK * d * n;
    const bf16* bias = biases + (size_t)k * n;
    const bf16* ea = EPI ? eas + (size_t)k * n : nullptr;
    const bf16* eb = EPI ? ebs + (size_t)k * n : nullptr;

    auto fetch_w = [&](int s) {
      const int j = s % per_tile;
      load_w(sm.w[s & 1], W, d, n, j < nf ? 0 : T, (j % nf) * BK,
             (s / per_tile) * BN, tid);
    };
    auto fetch_x = [&](int s) {
      load_x(sm, xin, gates, d, (s % per_tile % nf) * BK, tid);
    };

    fetch_w(0);
    fetch_x(0);
    cp_async_commit();
    float acc[2][8][4];
    for (int s = 0; s < nstage; ++s) {
      const int j = s % per_tile;
      const bool track = j < nf;
      if (j == 0) zero(acc);
      cp_async_wait_all();
      __syncthreads();  // stage s is in; every warp is done with stage s-1
      if (s + 1 < nstage) fetch_w(s + 1);
      if (track)
        build_track(sm, tid);
      else
        build_shared(sm, tid);
      __syncthreads();  // the A chunk is built; xs and gs are free
      if (s + 1 < nstage) fetch_x(s + 1);
      cp_async_commit();
      const bf16* wt = sm.w[s & 1];
      if (track) {
        mma_k16(acc, sm.a[0], wt, trk * BK, row0, col0, lane);
        if (j == nf - 1) {
          park_track(sm, acc, tid);
          zero(acc);
        }
      } else {
#pragma unroll
        for (int seg = 0; seg < NSB; ++seg)
          mma_k16(acc, sm.a[seg], wt, seg * BK, row0, col0, lane);
        if (j == per_tile - 1)
          epilogue<EPI>(sm, acc, xin, xo, bias, ea, eb, d, n, c0,
                        (s / per_tile) * BN, row0, col0, tid);
      }
    }
    // the next layer reads this layer's output rows written by other threads
    __syncthreads();
  }
}

}  // namespace

// Layers of the kernel's EPI form, every float tensor in bf16: x (nbar,
// 128, d), out, scratch (nbar, 128, n), gates (32, d), wbigs (K, 8d, n),
// biases, eas, ebs (K, n); aux (nbar, 14, 128) int32. d % 128 == 0 and n %
// 128 == 0 with c0 + n <= d; a chain (K > 1) takes n = d, c0 = 0. Without
// EPI, K = 1 and eas, ebs are not read.
template <bool EPI>
static int launch(const void* x, const void* aux, const void* gates,
                  const void* wbigs, const void* biases, const void* eas,
                  const void* ebs, void* out, void* scratch, int nbar, int d,
                  int n, int c0, int K, void* stream) {
  if (nbar <= 0) return 0;
  if (d <= 0 || d % BN != 0 || n <= 0 || n % BN != 0 || c0 < 0 ||
      c0 % 2 != 0 || c0 + n > d || K < 1 || (!EPI && K != 1) ||
      (K > 1 && n != d))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      gcl_eval_bf16_tc_kernel<EPI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gcl_eval_bf16_tc_kernel<EPI>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  gcl_eval_bf16_tc_kernel<EPI><<<nbar, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const int*)aux, (const bf16*)gates,
      (const bf16*)wbigs, (const bf16*)biases, (const bf16*)eas,
      (const bf16*)ebs, (bf16*)out, (bf16*)scratch, d, n, c0, K);
  return (int)cudaGetLastError();
}

// K chained eval layers (folded batch-norm, relu, residual); at K = 1
// output columns c0..c0+n-1 of the layer.
extern "C" int gcl_eval_bf16_launch(const void* x, const void* aux,
                                    const void* gates, const void* wbigs,
                                    const void* biases, const void* eas,
                                    const void* ebs, void* out, void* scratch,
                                    int nbar, int d, int n, int c0, int K,
                                    void* stream) {
  return launch<true>(x, aux, gates, wbigs, biases, eas, ebs, out, scratch,
                      nbar, d, n, c0, K, stream);
}

// One training-forward layer: out = v, wbig (8d, n), bias (n,), out (nbar,
// 128, n).
extern "C" int gcl_fwd_bf16_launch(const void* x, const void* aux,
                                   const void* gates, const void* wbig,
                                   const void* bias, void* out, int nbar,
                                   int d, int n, void* stream) {
  return launch<false>(x, aux, gates, wbig, bias, nullptr, nullptr, out, out,
                       nbar, d, n, 0, 1, stream);
}
