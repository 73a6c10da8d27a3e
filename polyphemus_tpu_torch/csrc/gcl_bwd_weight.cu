// GCL training backward, weight half: dWbig (8d, d), fp32.
//
// Replaces the Pallas kernel `_bwd_weight_kernel` of
// polyphemus_tpu/ops/kernels/gcl_pallas_bwd.py (kernel B of
// `gcl_backward_pallas`, its pallas_call at :564, called by the custom VJP
// `gcl_fused`). With gm = g * m and the message operands h_r of the forward
// (`gcl.gcl_fwd`):
//
//   dW_r = sum over bars and rows of h_r[row, :]^T gm[row, :]
//
// for the eight packed blocks [track 0..3 | self | onset | next | root]
// (h_root = x). The four track blocks contract only their own track's 32
// rows of each bar, the other four all 128. g may hold only n of the d
// output columns (a column shard under tensor parallelism, g (nbar, 128,
// n)): dWbig is then those n columns, (8d, n).
//
// What bounds it on an H100: operations, 2 * 640 * d * d flops a bar (335
// MFLOP at d = 512), fp32 FFMA on the CUDA cores: fp32 keeps fp32 rounding,
// so no tensor core multiplies here.
//
// Design: column c of every h_r depends only on column c of x and of the
// gate table, so a CTA that owns some input features rebuilds their
// messages itself and no h tensor reaches device memory. One CTA of 8 warps
// owns rows [c0, c0 + 32) of all 8 blocks x columns [j0, j0 + 64) (128 CTAs
// at d = 512, one wave) and walks every bar in order with its sums in
// registers; each element of dWbig is written once, after the last bar, so
// no partial goes to device memory and the result does not depend on the
// order the CTAs run in. Per bar:
// 1. x[:, c tile], g[:, j tile] and the bar's aux words come in by cp.async,
//    one bar ahead, into one of two stages.
// 2. The CTA rebuilds h_track, h_self, h_onset, h_next and x * m for its 32
//    features (each row once for all blocks and columns) with the forward's
//    fp32 operations. m is folded into these A tiles (the messages already
//    carry it, root is x * m; exact, m is 0 or 1), so g is used raw.
// 3. Warps 0-3 contract the rows of tracks 0 and 1, warps 4-7 those of
//    tracks 2 and 3: each row feeds its own track block and the four full
//    blocks, which share its g row. A thread holds 2 features x 8 columns of
//    each of the 4 full blocks and of its half's 2 track blocks (96 sums)
//    and runs 80 FFMAs for the 18 values it reads from shared memory a row
//    (two float4 of g, a float2 of each A tile). Every warp does the same
//    work: 64 rows a bar into 5 blocks.
// After the last bar the halves' full-block sums are added through shared
// memory in a fixed order (tracks 0-1, then 2-3).
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
struct Stage {
  alignas(16) float x[N][CT];    // x[bar][:, c tile]
  alignas(16) float g[N][JT];    // g[bar][:, j tile]
  alignas(16) int aux[N_AUX * N];
};

// One cell's statics for the rebuild, in three 16-byte words.
struct Row {
  int4 idx;                      // ps, ns, pn, dp | dn << 8 | dpn << 16
  float4 ok;                     // okp, okn, okpn, m
  float4 rec;                    // rtr, ron, rnx, single
};

struct Smem {
  Stage st[2];                   // bar b in st[b % 2]
  // the A tiles of the bar: [tile][cell][feature]; after the last bar the
  // first 32 KB take half 1's full-block sums
  alignas(16) float a[NA][N][CT];
  alignas(16) float gts[S][CT];  // gate_table[:, c tile]
  Row rows[N];                   // the statics of the bar
};

static_assert(sizeof(float) * 4 * CT * JT <= sizeof(float) * NA * N * CT,
              "half 1's full-block sums fit in the A tiles");

// x[bar][:, c0..c0+31], g[bar][:, j0..j0+63] and aux[bar]: 4 + 8 + 1.75
// 16-byte copies a thread; x rows d wide, g rows n wide.
__device__ __forceinline__ void load_stage(Stage& st, const float* xb,
                                           const float* gb, const int* ab,
                                           int d, int n, int c0, int j0,
                                           int tid) {
#pragma unroll
  for (int j = 0; j < N * CT / 4 / THREADS; ++j) {
    const int c = tid + j * THREADS;
    const int r = c / (CT / 4), q = (c % (CT / 4)) * 4;
    cp_async16(&st.x[r][q], xb + (size_t)r * d + c0 + q);
  }
#pragma unroll
  for (int j = 0; j < N * JT / 4 / THREADS; ++j) {
    const int c = tid + j * THREADS;
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

// The bar's A tiles from its stage. Warp w decodes the statics of the 16
// cells of steps 4w..4w+3 into sm.rows; thread (step c, features q..q+3)
// then rebuilds rows c, S + c, 2S + c and 3S + c of every tile, as
// `gcl_fwd` computes them. Only this warp reads the rows it decodes.
__device__ __forceinline__ void rebuild(Smem& sm, const Stage& st, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  if (lane < 16) {
    const int k = (lane >> 2) * S + 4 * warp + (lane & 3);
    const CellStatics cs = cell_statics(st.aux, k);
    Row& r = sm.rows[k];
    r.idx = make_int4(cs.ps, cs.ns, cs.pn, cs.dp | cs.dn << 8 | cs.dpn << 16);
    r.ok = make_float4(cs.okp, cs.okn, cs.okpn, cs.m);
    r.rec = make_float4(cs.rtr, cs.ron, cs.rnx, cs.single);
  }
  __syncwarp();
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
      st4(&sm.a[0][k][q], make_float4((vp.x + vn.x) * r.rec.x,
                                      (vp.y + vn.y) * r.rec.x,
                                      (vp.z + vn.z) * r.rec.x,
                                      (vp.w + vn.w) * r.rec.x));
      st4(&sm.a[1][k][q], mul(y[t], r.rec.w));     // self
      st4(&sm.a[2][k][q], others(y, t, r.rec.y));  // onset
      st4(&sm.a[3][k][q], others(z, t, r.rec.z));  // next
      st4(&sm.a[4][k][q], mul(xk[t], r.ok.w));     // root: x * m
    }
  }
}

// One bar into this thread's sums: rows of tracks 2h and 2h + 1; tr[tb]
// is track block 2h + tb, full[i] block T + i. The thread's features are
// 2 cg, 2 cg + 1, its columns 4 jg..4 jg + 3 and 32 + 4 jg..32 + 4 jg + 3.
__device__ __forceinline__ void bar_ffma(float (&tr)[2][2][8],
                                         float (&full)[4][2][8],
                                         const Smem& sm, const Stage& st,
                                         int h, int cg, int jg) {
#pragma unroll
  for (int tb = 0; tb < 2; ++tb) {
    const int k0 = (2 * h + tb) * S;
#pragma unroll 4
    for (int kk = 0; kk < S; ++kk) {
      const int k = k0 + kk;
      const float4 b0 = ld4(&st.g[k][4 * jg]);
      const float4 b1 = ld4(&st.g[k][JT / 2 + 4 * jg]);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      float2 a[NA];
#pragma unroll
      for (int i = 0; i < NA; ++i)
        a[i] = *reinterpret_cast<const float2*>(&sm.a[i][k][2 * cg]);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        tr[tb][0][jj] = fmaf(a[0].x, b[jj], tr[tb][0][jj]);
        tr[tb][1][jj] = fmaf(a[0].y, b[jj], tr[tb][1][jj]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          full[i][0][jj] = fmaf(a[1 + i].x, b[jj], full[i][0][jj]);
          full[i][1][jj] = fmaf(a[1 + i].y, b[jj], full[i][1][jj]);
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

__global__ void __launch_bounds__(THREADS, 1)
gcl_bwd_weight_kernel(const float* __restrict__ x, const float* __restrict__ g,
                      const int* __restrict__ aux,
                      const float* __restrict__ gates,
                      float* __restrict__ dwbig, int nbar, int d, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int j0 = blockIdx.x * JT, c0 = blockIdx.y * CT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = warp >> 2;                        // tracks 2h, 2h + 1
  const int cg = (warp & 3) * 4 + (lane >> 3);    // features 2 cg, 2 cg + 1
  const int jg = lane & 7;
  auto stage = [&](int b) {
    load_stage(sm.st[b & 1], x + (size_t)b * N * d, g + (size_t)b * N * n,
               aux + (size_t)b * N_AUX * N, d, n, c0, j0, tid);
    cp_async_commit();
  };

  stage(0);
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
    cp_async_wait_all();
    // bar's stage has landed, and no warp still reads the A tiles or the
    // stage that bar + 1 takes
    __syncthreads();
    if (bar + 1 < nbar) stage(bar + 1);
    const Stage& st = sm.st[bar & 1];
    rebuild(sm, st, tid);
    __syncthreads();
    bar_ffma(tr, full, sm, st, h, cg, jg);
  }

  // half 1 hands its full-block sums to half 0, which adds them to its own
  __syncthreads();
  float* red = &sm.a[0][0][0];
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

}  // namespace

// Bytes of dynamic shared memory a CTA of the kernel takes.
extern "C" int gcl_bwd_weight_smem_bytes() { return (int)sizeof(Smem); }

// x (nbar, N, d), g (nbar, N, n); aux (nbar, N_AUX, N); gates (S, d); all
// 16-byte aligned, d % 64 == 0, n % 64 == 0. Writes dwbig (8d, n).
extern "C" int gcl_bwd_weight_launch(const void* x, const void* g,
                                     const void* aux, const void* gates,
                                     void* dwbig, int nbar, int d, int n,
                                     void* stream) {
  if (d <= 0 || d % JT != 0 || n <= 0 || n % JT != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (nbar <= 0)
    return (int)cudaMemsetAsync(dwbig, 0, sizeof(float) * NBLK * d * n, st);
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      gcl_bwd_weight_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  gcl_bwd_weight_kernel<<<dim3(n / JT, d / CT), THREADS, smem, st>>>(
      (const float*)x, (const float*)g, (const int*)aux, (const float*)gates,
      (float*)dwbig, nbar, d, n);
  return (int)cudaGetLastError();
}
