// Fused dual contraction for the factored DESMO loss:
//
//     ax = Aᵀ X   (K, m)        xb = X Bᵀ   (n, K)
//
// for A (n, K) and B (K, m) fp32 row-major contiguous, X (n, m) fp32 with
// contiguous rows ldx >= m floats apart, K <= 128.
//
// Replaces the TPU kernels desmo_tpu/pallas/dual_gemm.py::_dual_kernel_split
// (the one on the cylinder training path, over X pre-split into bf16 hi/lo
// planes) and ::_dual_kernel (the same products over unsplit X). The hi/lo
// split existed because the TPU's matrix unit has no fp32 mode; here the
// products run on the tensor cores in three TF32 passes (3xTF32,
// tile_mma.cuh and col_mma.cuh), which keep the fp32-grade contract (about
// 5e-6 relative on the X-cancellation terms; single-pass TF32 would not).
//
// Bound on an H100 SXM: one call does 2 x 2 n m K flops and must read X
// once. In 3xTF32 at 495 TFLOP/s, with X at 3.35 TB/s: at (n, m, K) =
// (3961, 1001, 47) 4.5 us of products and 4.7 us of X (15.9 MB, which the
// eager loop keeps in the 50 MB L2), so bound by bytes; at (27000, 1000,
// 108) 70.7 us of products against 32 us of X (108 MB), so bound by
// operations.
//
// Design. One launch of two kinds of block, two blocks an SM, then a
// fixed-order sum of the partials:
//   * xb blocks form X·Bᵀ for a tile of kXbRows rows over a range of the
//     columns (xb_rows), chunk by chunk of kXbCols; a tile takes g_x column
//     ranges only where the tiles alone fill less than half the card
//     (cylinder: 2), so that no block walks all m columns alone;
//   * AᵀX blocks form the partial over a row group for a column slab of
//     kColTQ columns and 64 of K (lt_r_tile), walking the group's rows with
//     the sum in registers: g_r partials per slab, not one per 32-row tile
//     as before (11 MB of scratch at (27000, 1000, 108), where that took
//     364.6 MB);
//   * a second kernel sums the g_r partials of AᵀX and the g_x of xb in
//     their order, so two calls give identical bits.
// X is read by both kinds. The blocks go row group by row group (a group's
// AᵀX tasks, then the xb tiles of its rows), so that the second read of a
// row finds it in L2 (at (27000, 1000, 108) this took the copies alone from
// 185 to 163 us). One joint tile per (rows, slab) would read X once but
// write g_c partials of xb as well (93 MB at that shape with 128-column
// slabs).
// Both tiles stage their operands through a two-stage cp.async ring (two
// blocks an SM fit 113 KB each), 16-byte copies where rows are 16-byte
// aligned and 4-byte ones where not; each thread splits the pieces it
// copied into big and small TF32 planes once, so a fragment load is two
// shared loads, and each warp's products go pass by pass over its 2 m16 x
// 2-4 n8 tiles. X's rows take the 4-byte copies where m (or ldx) is not a
// multiple of 4, as at m = 1001; a caller that holds X with 16-byte rows
// (ldx a multiple of 4) gets the 16-byte ones (PERF.md has both times); xb
// zeroes the padding it copies.
// What bounds it now (measured on the H100, PERF.md): at the cylinder the
// host's share of a call and the launches' fixed costs; at (27000, 1000,
// 108) the instruction stream of the copies, splits and products more than
// any one of them (each of the three TF32 passes costs about 57 us, the
// copies alone 163 us, and the two overlap little). wgmma and TMA are not
// used.
// Ragged n and m, and K below its padded width, are masked here: the
// caller pads nothing. The kernels launch on the caller's stream, allocate
// nothing and do not synchronise; the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

#include "col_mma.cuh"

namespace {

constexpr int kThreads = kColThreads;
constexpr int kMaxK = 128;
constexpr int kXbRows = 64;            // rows of X per xb tile: two warp rows of two m16 tiles
constexpr int kXbCols = 32;            // columns per staged chunk: four k8 steps
constexpr int kXbLd = kXbCols + 4;     // = 4 mod 32: conflict-free row fragments

// Two blocks share an SM (two-stage rings in at most 113 KB, at most 128
// registers a thread), so that one block's copies and splits overlap the
// other's products; AᵀX is formed in tiles of kAxTP of K (two of them at K >
// 64, in neighbouring blocks).
constexpr int kBlocksPerSM = 2;
constexpr int kStages = 2;
constexpr int kAxTP = 64;

// xb's warps: 2 warp rows x WC column groups of NTW n8 tiles x WK splits of
// each chunk's k8 steps (warp sums added in warp order)
template <int KP>
struct XbWarps {
  static constexpr int NT8 = KP / 8;
  static constexpr int WC = NT8 >= 16 ? 4 : NT8 >= 6 ? 2 : 1;
  static constexpr int WK = 4 / WC;
  static constexpr int NTW = NT8 / WC;
  static_assert(NTW * WC == NT8 && WK * WC == 4, "the warps cover the n8 tiles");
};

// K padded to 16, 32, 48, 64 or 128 (128: the packed width of the seed-packed loss)
__host__ __device__ constexpr int xb_ring_floats(int KP) { return kStages * 2 * (kXbRows + KP) * kXbLd; }
__host__ __device__ constexpr int smem_floats(int KP) {
  return xb_ring_floats(KP) > col_ring_floats(kAxTP, kStages) ? xb_ring_floats(KP) : col_ring_floats(kAxTP, kStages);
}

// The launch's split: n_xb row tiles of xb, each over gx column ranges of
// xcols columns (a multiple of kXbCols); g_r row groups of rg rows (a
// multiple of kXbRows) x g_c slabs x g_p tiles of kAxTP of K of AᵀX. The blocks go
// group by group: a group's g_c g_p AᵀX tasks, then the tg = rg / kXbRows
// xb tiles of its rows, so that both kinds read a row of X at about the same
// time and the second read finds it in L2.
struct Plan {
  int n_xb, gx, xcols, gr, gc, gp, rg, tg;
};

__host__ __device__ inline int group_blocks(const Plan& pl) { return pl.gc * pl.gp + pl.tg * pl.gx; }
__host__ __device__ inline int grid_blocks(const Plan& pl) {
  return (pl.gr - 1) * group_blocks(pl) + pl.gc * pl.gp + (pl.n_xb - (pl.gr - 1) * pl.tg) * pl.gx;
}

struct DualArgs {
  const float *a, *b, *x;
  float *ax_part, *xb_part;  // (g_r, K, m) and (g_x, n, K) partials, or ax and xb themselves when g = 1
  int n, m, k;
  long long ldx;  // X's row stride, at least m
  Plan pl;
};

#ifndef DESMO_EMULATED_GRID
__device__ __forceinline__ float* shared_base() {
  extern __shared__ float4 dual_smem4[];
  return reinterpret_cast<float*>(dual_smem4);
}
#endif

// out[(r0 + i) K + k] = sum over j in [j_begin, j_end) of X[r0 + i][j]
// B[k][j] for i < kXbRows, r0 + i < n, k < K (j_begin a multiple of
// kXbCols). Chunks of X (kXbRows x kXbCols) and B (K x kXbCols) pass through
// the ring; each thread copies the 16-byte pieces at columns xc of rows xr +
// 32u of X and of B, and splits them once they land. Each chunk's sum is
// formed in fresh accumulators and added to the running one (see
// lt_r_tile).
template <int KP>
__device__ void xb_rows(const DualArgs& p, int r0, int j_begin, int j_end, float* out, float* ring) {
  using W = XbWarps<KP>;
  constexpr int LD = kXbLd, S = kStages, kStage = 2 * (kXbRows + KP) * LD;
  constexpr int PPR = kXbCols / 4, RPP = kThreads / PPR;  // pieces a row, rows a pass
  static_assert(kXbRows % RPP == 0, "a chunk of X is copied in whole passes");
  const int n = p.n, m = p.m, K = p.k;
  const int t = threadIdx.x, warp = t / 32, wr = warp % 2, wc = (warp / 2) % W::WC, wk = warp / (2 * W::WC);
  const int xc = 4 * (t % PPR), xr = t / PPR;
  const int kb = (K + 7) / 8 * 8;  // rows of B staged, zero from K on
  const int nch = (j_end - j_begin + kXbCols - 1) / kXbCols;
  const bool x_aligned = rows_aligned(p.x, p.ldx), b_aligned = rows_aligned(p.b, m);
  const float* xsrc = p.x + (long long)(r0 + xr) * p.ldx + xc;
  const float* bsrc = p.b + (long long)xr * m + xc;

  auto issue = [&](int c) {
    float* st = ring + (c % S) * kStage;
    const int j0 = j_begin + c * kXbCols, cv = min(4, max(0, j_end - j0 - xc));
#pragma unroll
    for (int u = 0; u < kXbRows / RPP; ++u) {
      const int v = r0 + xr + RPP * u < n ? cv : 0;
      stage4(st + (xr + RPP * u) * LD + xc, v > 0 ? xsrc + RPP * u * p.ldx + j0 : p.x, v, x_aligned);
    }
    float* bs = st + 2 * kXbRows * LD;
    for (int k = xr; k < kb; k += RPP) {
      const int v = k < K ? cv : 0;
      stage4(bs + k * LD + xc, v > 0 ? bsrc + (long long)(k - xr) * m + j0 : p.b, v, b_aligned);
    }
  };
  auto split = [&](int c) {
    float* st = ring + (c % S) * kStage;
    const int cv = min(4, max(0, j_end - (j_begin + c * kXbCols) - xc));
#pragma unroll
    for (int u = 0; u < kXbRows / RPP; ++u) {
      float* pb = st + (xr + RPP * u) * LD + xc;
      for (int e = cv; e < 4; ++e) pb[e] = 0.f;  // a 16-byte copy takes X's row padding along
      split4(pb, pb + kXbRows * LD);
    }
    float* bs = st + 2 * kXbRows * LD;
    for (int k = xr; k < kb; k += RPP) split4(bs + k * LD + xc, bs + KP * LD + k * LD + xc);
  };

  const bool aon[2] = {true, true};
  bool bon[W::NTW];  // this warp's n8 tiles of k below K
#pragma unroll
  for (int j = 0; j < W::NTW; ++j) bon[j] = 8 * (wc * W::NTW + j) < K;
  float run[2][W::NTW][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < W::NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) run[mt][j][e] = 0.f;
  for (int c = 0; c < S - 1; ++c) {
    if (c < nch) issue(c);
    cp_async_commit();
  }
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<S - 2>();
    split(c);
    __syncthreads();  // chunk c is in every thread's view, and chunk c - 1's stage is free
    if (c + S - 1 < nch) issue(c + S - 1);
    cp_async_commit();
    const float* xb_ = ring + (c % S) * kStage;
    const float* xs_ = xb_ + kXbRows * LD;
    const float* bb_ = xs_ + kXbRows * LD;
    const float* bs_ = bb_ + KP * LD;
    float acc[2][W::NTW][4];  // this chunk's sum, then added to the running one
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < W::NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
#pragma unroll
    for (int s = wk; s < kXbCols / 8; s += W::WK) {  // columns from j_end on are zero in both
      unsigned a_big[2][4], a_small[2][4], b_big[W::NTW][2], b_small[W::NTW][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int o = (32 * wr + 16 * mt) * LD + 8 * s;
        load_a_rows_split(xb_ + o, xs_ + o, LD, a_big[mt], a_small[mt]);
      }
#pragma unroll
      for (int j = 0; j < W::NTW; ++j) {
        const int o = 8 * (wc * W::NTW + j) * LD + 8 * s;
        if (bon[j]) load_b_cols_split(bb_ + o, bs_ + o, LD, b_big[j], b_small[j]);
      }
      mma_3xtf32_grid(acc, a_big, a_small, b_big, b_small, aon, bon);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < W::NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) run[mt][j][e] += acc[mt][j][e];
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
  float* red = ring;  // (WK, kXbRows, KP)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < W::NTW; ++j) {
      const int nt = wc * W::NTW + j;
      if (8 * nt < K) store_c(run[mt][j], red + (wk * kXbRows + 32 * wr + 16 * mt) * KP + 8 * nt, KP, 16, 8);
    }
  __syncthreads();
  for (int e = t; e < kXbRows * K; e += kThreads) {
    const int i = e / K, k = e % K;
    if (r0 + i >= n) break;
    float v = 0.f;
#pragma unroll
    for (int u = 0; u < W::WK; ++u) v += red[(u * kXbRows + i) * KP + k];  // in warp order
    out[(long long)(r0 + i) * K + k] = v;
  }
}

// Block b of row group gi = b / group_blocks: its AᵀX task (gj, pt), the
// partial over the group's rows for column slab gj and rows [pt kAxTP, (pt
// + 1) kAxTP) of K, or its xb tile over one of the g_x column ranges.
template <int KP>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) dual_kernel(DualArgs p) {
  float* ring = shared_base();
  const Plan& pl = p.pl;
  const int per = group_blocks(pl), gi = blockIdx.x / per, r = blockIdx.x % per, n_ax = pl.gc * pl.gp;
  if (r >= n_ax) {
    const int tile = gi * pl.tg + (r - n_ax) / pl.gx, xs = (r - n_ax) % pl.gx, j0 = xs * pl.xcols;
    xb_rows<KP>(p, tile * kXbRows, j0, min(p.m, j0 + pl.xcols), p.xb_part + (long long)xs * p.n * p.k, ring);
    return;
  }
  // the gp tiles of one slab are neighbours, so that they read the slab of X at about the same time
  const int gj = r / pl.gp, p0 = r % pl.gp * kAxTP, c0 = gj * kColTQ;
  const int i0 = gi * pl.rg, i1 = min(p.n, i0 + pl.rg);
  lt_r_tile<kAxTP, kStages>(col_operand(p.a, p.k, p.k), col_operand(p.x, p.ldx, p.m), i0, i1, p0, c0, ring,
                                   p.ax_part + (long long)gi * p.k * p.m + (long long)p0 * p.m + c0, p.m);
}

// ax[e] and xb[e] = the sums over their partials, in partial order: entries
// [0, K m) of ax over g_r parts, then [0, n K) of xb over g_x parts (a
// count of 1: nothing to do).
__global__ void __launch_bounds__(256)
reduce_parts_kernel(const float* __restrict__ ax_part, float* __restrict__ ax, int gr, int km,
                    const float* __restrict__ xb_part, float* __restrict__ xb, int gx, int nk) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const float* parts = ax_part;
  float* out = ax;
  int n_parts = gr, count = km;
  if (gr == 1 || idx >= km) {
    idx -= gr == 1 ? 0 : km;
    parts = xb_part;
    out = xb;
    n_parts = gx;
    count = nk;
    if (gx == 1) return;
  }
  if (idx >= count) return;
  // eight loads in flight at a time, added in part order
  float s = 0.f;
  int q = 0;
  for (; q + 8 <= n_parts; q += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = parts[(size_t)(q + u) * count + idx];
#pragma unroll
    for (int u = 0; u < 8; ++u) s += v[u];
  }
  for (; q < n_parts; ++q) s += parts[(size_t)q * count + idx];
  out[idx] = s;
}

template <int KP>
cudaError_t launch(const DualArgs& p, cudaStream_t s) {
  const size_t bytes = sizeof(float) * (size_t)smem_floats(KP);
  static bool sized = false;  // the attribute holds for the process
  if (!sized) {
    const cudaError_t err =
        cudaFuncSetAttribute((const void*)dual_kernel<KP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  dual_kernel<KP><<<grid_blocks(p.pl), kThreads, bytes, s>>>(p);
  return cudaGetLastError();
}

int padded_k(int k) { return k <= 16 ? 16 : k <= 32 ? 32 : k <= 48 ? 48 : k <= 64 ? 64 : 128; }

// The split for an (n, m, K) call on a card of `sms` SMs, aimed at one
// round of the card's resident blocks (two an SM), half of them for xb and
// half for AᵀX where the shape allows: each xb row tile takes g_x column
// ranges where the tiles alone fill less than half (so that no block walks
// all m columns alone), and AᵀX's row groups balance an AᵀX block's rows x
// slab against an xb block's rows x columns, or fill the rest of the round;
// a group's rows are a multiple of kXbRows.
Plan plan(int n, int m, int k, int sms) {
  Plan pl;
  const int target = kBlocksPerSM * sms, chunks = (m + kXbCols - 1) / kXbCols;
  pl.n_xb = (n + kXbRows - 1) / kXbRows;
  pl.gc = (m + kColTQ - 1) / kColTQ;
  pl.gp = (k + kAxTP - 1) / kAxTP;
  int gx = pl.n_xb >= target / 2 ? 1 : target / 2 / pl.n_xb;
  gx = gx < chunks ? gx : chunks;
  pl.xcols = (chunks + gx - 1) / gx * kXbCols;
  pl.gx = (m + pl.xcols - 1) / pl.xcols;  // no empty range
  const int xb_blocks = pl.n_xb * pl.gx, slabs = pl.gc * pl.gp;
  int gr = (xb_blocks + slabs / 2) / slabs;
  if (xb_blocks + gr * slabs < target) gr = (target - xb_blocks) / slabs;
  gr = gr < pl.n_xb ? gr : pl.n_xb;
  gr = gr > 1 ? gr : 1;
  pl.tg = ((n + gr - 1) / gr + kXbRows - 1) / kXbRows;
  pl.rg = pl.tg * kXbRows;
  pl.gr = (n + pl.rg - 1) / pl.rg;
  return pl;
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

}  // namespace

extern "C" {

// Largest K the kernel takes.
int desmo_dual_max_k(void) { return kMaxK; }

// The partials an (n, m, K) call writes on the current device: out[0] =
// g_r, of AᵀX (K, m) each, and out[1] = g_x, of xb (n, K) each (none where
// 1). Returns a cudaError_t.
int desmo_dual_plan(int n, int m, int k, int* out) {
  if (n <= 0 || m <= 0 || k <= 0 || k > kMaxK) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const Plan pl = plan(n, m, k, sms);
  out[0] = pl.gr;
  out[1] = pl.gx;
  return (int)cudaSuccess;
}

// X's rows lie ldx >= m floats apart. ax_part: g_r * k * m floats, xb_part:
// g_x * n * k floats (each unused where its count is 1), the counts from
// desmo_dual_plan(n, m, k). Returns a cudaError_t.
int desmo_dual_contractions(const float* a, const float* b, const float* x, long long ldx, float* ax_part,
                            float* xb_part, float* ax, float* xb, int n, int m, int k, int gr, int gx, void* stream) {
  if (n <= 0 || m <= 0 || k <= 0 || k > kMaxK || ldx < m) return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = (cudaError_t)sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const Plan pl = plan(n, m, k, sms);
  if (pl.gr != gr || pl.gx != gx || (gr > 1 && !ax_part) || (gx > 1 && !xb_part)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DualArgs p{a, b, x, gr > 1 ? ax_part : ax, gx > 1 ? xb_part : xb, n, m, k, ldx, pl};
  switch (padded_k(k)) {
    case 16: err = launch<16>(p, s); break;
    case 32: err = launch<32>(p, s); break;
    case 48: err = launch<48>(p, s); break;
    case 64: err = launch<64>(p, s); break;
    default: err = launch<128>(p, s); break;
  }
  if (err != cudaSuccess || (gr == 1 && gx == 1)) return (int)err;
  const int km = k * m, nk = n * k, count = (gr > 1 ? km : 0) + (gx > 1 ? nk : 0);
  reduce_parts_kernel<<<(count + 255) / 256, 256, 0, s>>>(ax_part, ax, gr, km, xb_part, xb, gx, nk);
  return (int)cudaGetLastError();
}

}  // extern "C"
