// GCL training backward, weight half, fp32, for bars of 4 x S cells at any S
// that is a multiple of 4 up to 48 but 32 (resolutions 1-12 but 8): dWbig
// (8d, n). At S = 32 the port launches `gcl_bwd_weight.cu`; this source
// takes the other grids.
//
// Replaces, in fp32 and at those grids, the Pallas kernel
// `_bwd_weight_kernel` of polyphemus_tpu/ops/kernels/gcl_pallas_bwd.py
// (kernel B of `gcl_backward_pallas`, its pallas_call at :564, called by the
// custom VJP `gcl_fused`), which takes the steps a bar as `n_steps`
// (:204-215). It computes what `gcl_bwd_weight.cu` computes:
//
//   dW_r = sum over bars and rows of h_r[row, :]^T gm[row, :]
//
// for the eight packed blocks; the four track blocks contract only their
// own track's S rows of each bar, the other four all N = 4 S. g may hold n
// of the d output columns (a column shard: dWbig (8d, n)).
//
// What bounds it on an H100: operations, 2 N 5d n flops a bar (126 MFLOP
// at S = 12, 503 MFLOP at S = 48, d = n = 512), fp32 FFMA on the CUDA
// cores.
//
// Design: `gcl_bwd_weight.cu`'s, templated on S (a CTA owns rows [c0, c0 +
// 32) of all 8 blocks x columns [j0, j0 + 64) and walks every bar with its
// 96 sums a thread in registers, rebuilding the messages of its 32
// features once a bar; each element of dWbig written once, bitwise
// repeatable). The thread tiling is over features and columns, and a warp
// walks the rows of its two tracks one by one, so it takes any S without
// padding. What changes with S:
// - The statics of the bar's N cells are decoded by the whole CTA (at S =
//   32 each warp decodes the 16 cells it rebuilds), one barrier before the
//   rebuild.
// - The bar's inputs (x and g tiles and aux words: 1760 bytes a cell) and
//   its 5 A tiles (640 bytes a cell) grow with N. Up to S = 32 two stages
//   run one bar ahead as at S = 32 (175 KB of shared memory at S = 28);
//   above it one stage (217 KB at S = 48, where two would take 300 KB): the
//   next bar's copies start after this bar's product, so they are not
//   overlapped with compute.
// - Half 1's full-block sums are added through shared memory that holds
//   at least 32 KB at every S (the A tiles are smaller below S = 13).
#include "gcl_common.cuh"
#include "mma_bf16.cuh"  // cp.async helpers

namespace {

using namespace gcl;
using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait_all;

constexpr int THREADS = 256;
constexpr int CT = 32;           // input features (rows of each block) a CTA
constexpr int JT = 64;           // output features (columns) a CTA
constexpr int NA = 5;            // A tiles: track, self, onset, next, root

// One bar's inputs, by cp.async.
template <int S>
struct Stage {
  alignas(16) float x[T * S][CT];    // x[bar][:, c tile]
  alignas(16) float g[T * S][JT];    // g[bar][:, j tile]
  alignas(16) int aux[N_AUX * T * S];
};

// One cell's statics for the rebuild, in three 16-byte words.
struct Row {
  int4 idx;                      // ps, ns, pn, dp | dn << 8 | dpn << 16
  float4 ok;                     // okp, okn, okpn, m
  float4 rec;                    // rtr, ron, rnx, single
};

template <int S>
struct Smem {
  static constexpr int N = T * S;
  static constexpr int NST = S > 32 ? 1 : 2;   // bars in shared memory
  // the A tiles of the bar, [tile][cell][feature]; after the last bar the
  // first 32 KB take half 1's full-block sums
  static constexpr int AF = NA * N * CT > 4 * CT * JT ? NA * N * CT
                                                      : 4 * CT * JT;
  Stage<S> st[NST];              // bar b in st[b % NST]
  alignas(16) float a[AF];
  alignas(16) float gts[S][CT];  // gate_table[:, c tile]
  Row rows[N];                   // the statics of the bar
};

// x[bar][:, c0..c0+31], g[bar][:, j0..j0+63] and aux[bar] by 16-byte
// copies; x rows d wide, g rows n wide.
template <int S>
__device__ __forceinline__ void load_stage(Stage<S>& st, const float* xb,
                                           const float* gb, const int* ab,
                                           int d, int n, int c0, int j0,
                                           int tid) {
  constexpr int N = T * S;
  for (int c = tid; c < N * CT / 4; c += THREADS) {
    const int r = c / (CT / 4), q = (c % (CT / 4)) * 4;
    cp_async16(&st.x[r][q], xb + (size_t)r * d + c0 + q);
  }
  for (int c = tid; c < N * JT / 4; c += THREADS) {
    const int r = c / (JT / 4), q = (c % (JT / 4)) * 4;
    cp_async16(&st.g[r][q], gb + (size_t)r * n + j0 + q);
  }
  for (int c = tid; c < N_AUX * N / 4; c += THREADS)
    cp_async16(st.aux + c * 4, ab + c * 4);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float4 mul(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

// relu(a * b) * s: a message through a relation, s its 0/1 validity
__device__ __forceinline__ float4 msg(float4 a, float4 b, float s) {
  return make_float4(fmaxf(a.x * b.x, 0.f) * s, fmaxf(a.y * b.y, 0.f) * s,
                     fmaxf(a.z * b.z, 0.f) * s, fmaxf(a.w * b.w, 0.f) * s);
}

// (v0 + v1 + v2 + v3 - v[t]) * s
__device__ __forceinline__ float4 others(const float4 (&v)[T], int t,
                                         float s) {
  return make_float4((v[0].x + v[1].x + v[2].x + v[3].x - v[t].x) * s,
                     (v[0].y + v[1].y + v[2].y + v[3].y - v[t].y) * s,
                     (v[0].z + v[1].z + v[2].z + v[3].z - v[t].z) * s,
                     (v[0].w + v[1].w + v[2].w + v[3].w - v[t].w) * s);
}

// The statics of the bar's N cells into sm.rows; the caller synchronises.
template <int S>
__device__ __forceinline__ void decode(Smem<S>& sm, const Stage<S>& st,
                                       int tid) {
  for (int k = tid; k < T * S; k += THREADS) {
    const CellStatics cs = cell_statics_grid(st.aux, k, T * S, S);
    Row& r = sm.rows[k];
    r.idx = make_int4(cs.ps, cs.ns, cs.pn, cs.dp | cs.dn << 8 | cs.dpn << 16);
    r.ok = make_float4(cs.okp, cs.okn, cs.okpn, cs.m);
    r.rec = make_float4(cs.rtr, cs.ron, cs.rnx, cs.single);
  }
}

// The bar's A tiles from its stage and decoded statics: thread (step c,
// features q..q+3) rebuilds rows c, S + c, 2S + c and 3S + c of every tile,
// as `gcl_fwd` computes them.
template <int S>
__device__ __forceinline__ void rebuild(Smem<S>& sm, const Stage<S>& st,
                                        int tid) {
  constexpr int N = T * S;
  float (*a)[N][CT] = reinterpret_cast<float (*)[N][CT]>(sm.a);
  for (int it = tid; it < S * CT / 4; it += THREADS) {
    const int c = it / (CT / 4), q = (it % (CT / 4)) * 4;
    auto ldx = [&](int r) { return ld4(&st.x[r][q]); };
    auto gate = [&](int s) { return ld4(&sm.gts[s][q]); };
    const float4 g0 = gate(0);
    float4 xk[T], y[T], z[T];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const Row& r = sm.rows[t * S + c];
      xk[t] = ldx(t * S + c);
      y[t] = msg(xk[t], g0, r.ok.w);
      z[t] = msg(ldx(r.idx.z), gate(r.idx.w >> 16), r.ok.z);
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int k = t * S + c;
      const Row& r = sm.rows[k];
      const float4 vp = msg(ldx(r.idx.x), gate(r.idx.w & 255), r.ok.x);
      const float4 vn = msg(ldx(r.idx.y), gate((r.idx.w >> 8) & 255), r.ok.y);
      st4(&a[0][k][q], make_float4((vp.x + vn.x) * r.rec.x,
                                   (vp.y + vn.y) * r.rec.x,
                                   (vp.z + vn.z) * r.rec.x,
                                   (vp.w + vn.w) * r.rec.x));
      st4(&a[1][k][q], mul(y[t], r.rec.w));     // self
      st4(&a[2][k][q], others(y, t, r.rec.y));  // onset
      st4(&a[3][k][q], others(z, t, r.rec.z));  // next
      st4(&a[4][k][q], mul(xk[t], r.ok.w));     // root: x * m
    }
  }
}

// One bar into this thread's sums: rows of tracks 2h and 2h + 1; tr[tb]
// is track block 2h + tb, full[i] block T + i. The thread's features are
// 2 cg, 2 cg + 1, its columns 4 jg..4 jg + 3 and 32 + 4 jg..32 + 4 jg + 3.
template <int S>
__device__ __forceinline__ void bar_ffma(float (&tr)[2][2][8],
                                         float (&full)[4][2][8],
                                         const Smem<S>& sm,
                                         const Stage<S>& st, int h, int cg,
                                         int jg) {
  constexpr int N = T * S;
  const float (*a)[N][CT] = reinterpret_cast<const float (*)[N][CT]>(sm.a);
#pragma unroll
  for (int tb = 0; tb < 2; ++tb) {
    const int k0 = (2 * h + tb) * S;
#pragma unroll 4
    for (int kk = 0; kk < S; ++kk) {
      const int k = k0 + kk;
      const float4 b0 = ld4(&st.g[k][4 * jg]);
      const float4 b1 = ld4(&st.g[k][JT / 2 + 4 * jg]);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      float2 av[NA];
#pragma unroll
      for (int i = 0; i < NA; ++i)
        av[i] = *reinterpret_cast<const float2*>(&a[i][k][2 * cg]);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        tr[tb][0][jj] = fmaf(av[0].x, b[jj], tr[tb][0][jj]);
        tr[tb][1][jj] = fmaf(av[0].y, b[jj], tr[tb][1][jj]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          full[i][0][jj] = fmaf(av[1 + i].x, b[jj], full[i][0][jj]);
          full[i][1][jj] = fmaf(av[1 + i].y, b[jj], full[i][1][jj]);
        }
      }
    }
  }
}

// Sums v, two rows (features 2 cg, 2 cg + 1) x 8 columns, into a 32 x 64
// tile at p whose rows are `pitch` floats apart; add_tile adds such a tile
// of pitch JT to them.
__device__ __forceinline__ void put_tile(float* p, size_t pitch,
                                         const float (&v)[2][8], int cg,
                                         int jg) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* row = p + (2 * cg + r) * pitch + 4 * jg;
    st4(row, make_float4(v[r][0], v[r][1], v[r][2], v[r][3]));
    st4(row + JT / 2, make_float4(v[r][4], v[r][5], v[r][6], v[r][7]));
  }
}

__device__ __forceinline__ void add_tile(float (&v)[2][8], const float* p,
                                         int cg, int jg) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float* row = p + (2 * cg + r) * JT + 4 * jg;
    const float4 lo = ld4(row), hi = ld4(row + JT / 2);
    const float w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) v[r][jj] += w[jj];
  }
}

template <int S>
__global__ void __launch_bounds__(THREADS, 1)
gcl_bwd_weight_grid_kernel(const float* __restrict__ x,
                           const float* __restrict__ g,
                           const int* __restrict__ aux,
                           const float* __restrict__ gates,
                           float* __restrict__ dwbig, int nbar, int d,
                           int n) {
  using SM = Smem<S>;
  constexpr int N = SM::N, NST = SM::NST;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SM& sm = *reinterpret_cast<SM*>(smem_raw);
  const int j0 = blockIdx.x * JT, c0 = blockIdx.y * CT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = warp >> 2;                        // tracks 2h, 2h + 1
  const int cg = (warp & 3) * 4 + (lane >> 3);    // features 2 cg, 2 cg + 1
  const int jg = lane & 7;
  auto stage = [&](int b) {
    load_stage(sm.st[b % NST], x + (size_t)b * N * d, g + (size_t)b * N * n,
               aux + (size_t)b * N_AUX * N, d, n, c0, j0, tid);
    cp_async_commit();
  };

  if (NST == 2) stage(0);
  for (int e = tid; e < S * CT; e += THREADS)
    sm.gts[e / CT][e % CT] = gates[(size_t)(e / CT) * d + c0 + e % CT];
  float tr[2][2][8], full[4][2][8];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      tr[0][r][jj] = tr[1][r][jj] = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) full[i][r][jj] = 0.f;
    }

  for (int bar = 0; bar < nbar; ++bar) {
    if (NST == 1) {
      // no warp still reads the stage or the A tiles of the previous bar
      __syncthreads();
      stage(bar);
    }
    cp_async_wait_all();
    // bar's stage has landed, and (two stages) no warp still reads the A
    // tiles or the stage that bar + 1 takes
    __syncthreads();
    if (NST == 2 && bar + 1 < nbar) stage(bar + 1);
    const Stage<S>& st = sm.st[bar % NST];
    decode(sm, st, tid);
    __syncthreads();
    rebuild(sm, st, tid);
    __syncthreads();
    bar_ffma(tr, full, sm, st, h, cg, jg);
  }

  // half 1 hands its full-block sums to half 0, which adds them to its own
  __syncthreads();
  float* red = sm.a;
  if (h == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) put_tile(red + i * CT * JT, JT, full[i], cg, jg);
  }
  __syncthreads();
  const size_t pitch = (size_t)n;
  float* out = dwbig + (size_t)c0 * n + j0;
  if (h == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      add_tile(full[i], red + i * CT * JT, cg, jg);
      put_tile(out + (size_t)(T + i) * d * n, pitch, full[i], cg, jg);
    }
  }
#pragma unroll
  for (int tb = 0; tb < 2; ++tb)
    put_tile(out + (size_t)(2 * h + tb) * d * n, pitch, tr[tb], cg, jg);
}

template <int S>
int launch(const void* x, const void* g, const void* aux, const void* gates,
           void* dwbig, int nbar, int d, int n, cudaStream_t st) {
  static_assert(sizeof(Smem<S>) <= 232448, "a CTA's shared memory");
  if (nbar <= 0)
    return (int)cudaMemsetAsync(dwbig, 0, sizeof(float) * NBLK * d * n, st);
  const int smem = (int)sizeof(Smem<S>);
  cudaError_t err = cudaFuncSetAttribute(
      gcl_bwd_weight_grid_kernel<S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  gcl_bwd_weight_grid_kernel<S><<<dim3(n / JT, d / CT), THREADS, smem, st>>>(
      (const float*)x, (const float*)g, (const int*)aux, (const float*)gates,
      (float*)dwbig, nbar, d, n);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory a CTA of the kernel takes at S steps a
// bar (0 for a grid it does not take).
extern "C" int gcl_bwd_weight_grid_smem_bytes(int S) {
  switch (S) {
#define GCL_SMEM(s) \
  case s:           \
    return (int)sizeof(Smem<s>);
    GCL_GRID_STEPS(GCL_SMEM)
#undef GCL_SMEM
  }
  return 0;
}

// x (nbar, 4 S, d), g (nbar, 4 S, n); aux (nbar, N_AUX, 4 S); gates (S, d);
// all 16-byte aligned, d % 64 == 0, n % 64 == 0; S a multiple of 4 up to 48
// but 32. Writes dwbig (8d, n).
extern "C" int gcl_bwd_weight_grid_launch(const void* x, const void* g,
                                          const void* aux, const void* gates,
                                          void* dwbig, int nbar, int S, int d,
                                          int n, void* stream) {
  if (d <= 0 || d % JT != 0 || n <= 0 || n % JT != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (S) {
#define GCL_LAUNCH(s) \
  case s:             \
    return launch<s>(x, g, aux, gates, dwbig, nbar, d, n, st);
    GCL_GRID_STEPS(GCL_LAUNCH)
#undef GCL_LAUNCH
  }
  return (int)cudaErrorInvalidValue;
}
