// One optimizer step's forward and gradient partials of DESMO over one
// rank's rows, in one cooperative launch. The ranks all-reduce the partial
// sums between launches and then compute the replicated update of B, the
// coefficients, omega and the scheduler, and each its own rows' phi update,
// with plain PyTorch operations (desmo_tpu_torch/kernels/shard_step.py, which
// holds the plain version of this kernel beside its wrapper).
//
// Replaces the TPU kernel desmo_tpu/pallas/shard_step.py:74 _make_step_kernel
// (one seed, desmo and Fourier forms: the Fourier form's B is built from the
// series outside the kernel, so the kernel is the same). Over the rank's
// n_loc rows (fp32 in and out), with nm = n_total * m the global count:
//   lat = pod * phiᵀ, the library D and A = D * c, xb = X Bᵀ,
//   dA = 2/nm (A gb - xb), the per-row latent gradient dl without the ortho
//   term (its sign needs the all-reduced latent Gram), and the partial sums
//   ax = AᵀX (K, m), ga = AᵀA (K, K), the latent Gram latᵀlat (r, r), the
//   coefficient gradient sum(dA * D) (K), the omega gradient (3r), and
//   max |omega * lat| (all-reduced with MAX, the others with SUM).
// The reference's [1 | lat] Gram (auga) carries latᵀlat in its lanes 1..r;
// the rest of it is read by nothing, so only latᵀlat is formed.
//
// Bound on an H100 SXM at the cylinder shape on one rank (n=3961, m=1001,
// r=4, P=3: K=47): AᵀX and X Bᵀ 2nmK each, A gb 2nK² and the symmetric
// AᵀA nK(K+1), about 0.77 GFLOP: 11.5 us at the 67 TFLOP/s fp32 rate outside
// the tensor cores; X (15.9 MB) read once takes 4.7 us at 3.35 TB/s.
// fp32-FMA-bound.
//
// Design (simple first; wgmma/TMA are later work). One persistent
// cooperative launch of one block per SM, two phases and one grid barrier:
//   1. rows: each block owns a contiguous row range and, in tiles of kRT
//      rows, builds [1 | lat], D, its trig derivative and A in shared memory,
//      writes A to the scratch, forms X Bᵀ for its rows (chunks of X and B
//      staged in shared memory, the next chunk loaded into registers
//      meanwhile), dA, dl, and per-block partials of AᵀA, latᵀlat, the
//      coefficient and omega gradients and max |omega * lat|;
//   2. after the barrier: the partials are summed over the blocks (one warp
//      per entry, block order), block 0 takes the max, and each block forms
//      ax = AᵀX for its slab of columns (A read back from L2 in prefetched
//      tiles, each thread holding up to 4 k x 8 columns, warps summed in
//      warp order).
// The rows and columns phases are those of the single-device mega-kernel
// (csrc/train_chunk.cu, one seed). Every sum across threads or blocks runs
// in a fixed order, so two launches give identical bits. Products are plain
// fp32 FMA; trig is CUDA's full-range sincosf/tanhf (the TPU's bf16 hi/lo
// passes, 128-lane packing, selection matmuls and fast sin/cos do not carry
// over). The polynomial backward is the product rule over the P factors, so
// it needs no guard where lat == 0 (the reference divides by lat there and
// gives 0); its dl differs at such rows, but the phi gradient multiplies dl
// by pod, which is 0 wherever lat is. The kernel allocates nothing and does
// not synchronise; the entry point returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRT = 32;   // rows per tile of the rows phase
constexpr int kCW = 64;   // columns of X per staged chunk (xb)
constexpr int kPrefX1 = kRT * kCW / kThreads;  // X values a thread prefetches per chunk
constexpr int kSW = 8;    // columns per sub-slab (ax); its rows are read as two float4
static_assert(kSW == 8, "the columns phase reads a row of its X tile as two float4");
constexpr int kMaxK = 128;
constexpr int kMaxR = 8;
constexpr int kMaxP = 8;
constexpr int kCT = 4;    // column table: seed, kind (0 polynomial, 1 sin, 2 cos, 3 tanh),
                          // latent lane, omega slot, then the P factor lanes
constexpr int kGroup = 8; // entries a thread carries side by side in dA and AᵀA

// The kernel is compiled for K padded to KP = 32, 48, 64 or 128, so that the
// register tiles and loops over k have fixed sizes.
__host__ __device__ constexpr int padded_k(int K) { return K <= 32 ? 32 : K <= 48 ? 48 : K <= 64 ? 64 : 128; }
// rows per staged tile of the columns phase
__host__ __device__ constexpr int ax_tile_rows(int KP) { return KP <= 64 ? 128 : 64; }

struct Args {
  const float* pod;    // (n, r): this rank's rows
  const float* x;      // (n, m)
  const float* phi;    // (r, n)
  const float* b;      // (K, m)
  const float* gb;     // (K, K) = B Bᵀ
  const float* coef;   // (K): c ‖ c_trig (kind-major)
  const float* omega;  // (3r), kind-major
  const int* ctab;     // (K, kCT + P) column table
  float* dl;           // out (n, r)
  float* sums;         // out: ax (K, m), ga (K, K), latᵀlat (r, r), gcoef (K), gomega (3r)
  float* max_arg;      // out (1)
  float* work;         // scratch, make_layout(...).total floats
  int n, m, r, P, K;
  float two_nm;        // 2 / (n_total m)
};

// Offsets (in floats) into the scratch for a grid of G blocks.
struct Layout {
  long long a, part, part_max, total;
  int es;  // entries of a block's partial: ga, latᵀlat, gcoef, gomega
};

__host__ __device__ inline Layout make_layout(int n, int r, int K, int G) {
  Layout L;
  L.es = K * K + r * r + K + 3 * r;
  long long o = 0;
  L.a = o;        o += (long long)n * K;
  L.part = o;     o += (long long)G * L.es;
  L.part_max = o; o += G;
  L.total = o;
  return L;
}

__host__ __device__ inline int round4(int v) { return (v + 3) / 4 * 4; }

// Shared floats: the column table, then the larger of the two phases' own.
__host__ __device__ inline int smem_floats(int r, int K, int P) {
  const int ld = K + 1, KP = padded_k(K), rt3 = ax_tile_rows(KP);
  const int rows = round4(K) + round4(3 * r) + round4(K * K) + kRT * (r + 1) + 4 * kRT * ld + kRT * (kCW + 1) +
                   KP * (kCW + 1) + kThreads + round4(K) + round4(3 * r);
  const int columns = rt3 * K + KP + rt3 * kSW + kWarps * K * kSW + kThreads;
  return round4(K * (kCT + P)) + (rows > columns ? rows : columns);
}

#ifndef DESMO_EMULATED_GRID
__device__ __forceinline__ float* shared_base() {
  extern __shared__ float4 desmo_smem4[];
  return reinterpret_cast<float*>(desmo_smem4);
}
#endif

// max that propagates NaN from either side, as torch.maximum does
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }

// Fixed-order tree reduction over the block; every thread gets the result.
__device__ float block_max(float v, float* red) {
  const int t = threadIdx.x;
  __syncthreads();
  red[t] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) red[t] = max_nan(red[t], red[t + s]);
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

// out[e] = the sum over the grid's blocks b of part[b * stride + e], for
// e < count: one warp per entry, lane l adding partials l, l + 32, ... in
// order, then the 32 lane sums added in lane order. Fixed order, so
// repeatable; every thread of the block must call it.
__device__ void reduce_partials(const float* part, long long stride, int count, float* out, float* red) {
  const int t = threadIdx.x, lane = t % 32, warp = t / 32, G = gridDim.x;
  for (int e0 = blockIdx.x * kWarps; e0 < count; e0 += G * kWarps) {
    const int e = e0 + warp;
    float s = 0.f;
    if (e < count)
      for (int bb = lane; bb < G; bb += 32) s += part[bb * stride + e];
    __syncthreads();
    red[t] = s;
    __syncthreads();
    if (lane == 0 && e < count) {
      float v = 0.f;
      for (int l = 0; l < 32; ++l) v += red[t + l];
      out[e] = v;
    }
  }
  __syncthreads();
}

// Phase 1: forward, xb, dA, dl and the per-block partials over the block's rows.
template <int KP>
__device__ void row_phase(const Args& a, const Layout& L, const int* ct, float* smem) {
  constexpr int kXC = KP / 16;                   // xb: k = tx + 16c, c < kXC
  constexpr int kPrefB1 = KP * kCW / kThreads;   // B values prefetched per thread
  const int t = threadIdx.x, b = blockIdx.x, G = gridDim.x;
  const int n = a.n, m = a.m, r = a.r, P = a.P, K = a.K, ld = K + 1;
  const int AW = r + 1, CT = kCT + P, T = K - 3 * r, kk = K * K;
  float* p = smem;
  float* c_s = p;   p += round4(K);
  float* om_s = p;  p += round4(3 * r);
  float* gb_s = p;  p += round4(kk);
  float* aug_s = p; p += kRT * AW;
  float* D_s = p;   p += kRT * ld;
  float* A_s = p;   p += kRT * ld;
  float* V_s = p;   p += kRT * ld;  // d D / d arg on the trig columns, 0 on the polynomial ones
  float* Y_s = p;   p += kRT * ld;  // xb, then dA
  float* X_s = p;   p += kRT * (kCW + 1);
  float* B_s = p;   p += KP * (kCW + 1);  // rows K..KP-1 stay zero
  float* red = p;   p += kThreads;
  float* cacc = p;  p += round4(K);
  float* oacc = p;

  float* part = a.work + L.part + (long long)b * L.es;
  float* part_ga = part;
  float* part_lat = part + kk;
  float* A_g = a.work + L.a;

  for (int k = t; k < K; k += kThreads) { c_s[k] = a.coef[k]; cacc[k] = 0.f; }
  for (int q = t; q < 3 * r; q += kThreads) { om_s[q] = a.omega[q]; oacc[q] = 0.f; }
  for (int e = t; e < kk; e += kThreads) gb_s[e] = a.gb[e];
  for (int e = t; e < kk + r * r; e += kThreads) part[e] = 0.f;
  float vmax = 0.f;

  const int Rw = (n + G - 1) / G, row_begin = b * Rw, row_end = min(n, row_begin + Rw);
  for (int r0 = row_begin; r0 < row_end; r0 += kRT) {
    const int rows = min(kRT, row_end - r0);
    __syncthreads();  // the constants are loaded and the previous tile is consumed
    // [1 | lat]: lane 1 + j holds pod[row][j] * phi[j][row]
    for (int e = t; e < kRT * AW; e += kThreads) {
      const int i = e / AW, j = e % AW, row = r0 + i;
      float v = 0.f;
      if (i < rows) v = j == 0 ? 1.f : a.pod[(long long)row * r + j - 1] * a.phi[(long long)(j - 1) * n + row];
      aug_s[i * AW + j] = v;
    }
    __syncthreads();
    // the dictionary D, its trig derivative V and A = D * c
    for (int e = t; e < kRT * K; e += kThreads) {
      const int i = e / K, k = e % K;
      const int* ck = ct + k * CT;
      float d = 0.f, v = 0.f;
      if (i < rows) {
        const float* ag = aug_s + i * AW;
        const int kind = ck[1];
        if (kind == 0) {
          d = ag[ck[kCT]];
          for (int q = 1; q < P; ++q) d *= ag[ck[kCT + q]];
        } else {
          const float arg = ag[ck[2]] * om_s[ck[3]];
          vmax = max_nan(vmax, fabsf(arg));
          if (kind == 3) {
            d = tanhf(arg);
            v = 1.f - d * d;
          } else {
            float sn, cs;
            sincosf(arg, &sn, &cs);
            d = kind == 1 ? sn : cs;
            v = kind == 1 ? cs : -sn;
          }
        }
      }
      D_s[i * ld + k] = d;
      V_s[i * ld + k] = v;
      A_s[i * ld + k] = d * c_s[k];
    }
    __syncthreads();
    for (int e = t; e < rows * K; e += kThreads) {
      const int i = e / K, k = e % K;
      A_g[(long long)(r0 + i) * K + k] = A_s[i * ld + k];
    }
    // xb[i][k] = sum_j X[r0 + i][j] * B[k][j]: rows ty and ty + 16, k = tx + 16c.
    // The next chunk of X and B is loaded into registers while this one is used.
    {
      const int tx = t % 16, ty = t / 16;
      float acc[2][kXC];
#pragma unroll
      for (int c = 0; c < kXC; ++c) acc[0][c] = acc[1][c] = 0.f;
      float px[kPrefX1], pb[kPrefB1];
      auto fetch = [&](int j0) {
#pragma unroll
        for (int u = 0; u < kPrefX1; ++u) {
          const int e = t + kThreads * u, i = e / kCW, col = j0 + e % kCW;
          px[u] = (i < rows && col < m) ? a.x[(long long)(r0 + i) * m + col] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kPrefB1; ++u) {
          const int e = t + kThreads * u, k = e / kCW, col = j0 + e % kCW;
          pb[u] = (k < K && col < m) ? a.b[(long long)k * m + col] : 0.f;
        }
      };
      fetch(0);
      for (int j0 = 0; j0 < m; j0 += kCW) {
        __syncthreads();
#pragma unroll
        for (int u = 0; u < kPrefX1; ++u) {
          const int e = t + kThreads * u;
          X_s[(e / kCW) * (kCW + 1) + e % kCW] = px[u];
        }
#pragma unroll
        for (int u = 0; u < kPrefB1; ++u) {
          const int e = t + kThreads * u;
          B_s[(e / kCW) * (kCW + 1) + e % kCW] = pb[u];
        }
        __syncthreads();
        if (j0 + kCW < m) fetch(j0 + kCW);
        for (int jj = 0; jj < kCW; ++jj) {
          const float x0 = X_s[ty * (kCW + 1) + jj], x1 = X_s[(ty + 16) * (kCW + 1) + jj];
#pragma unroll
          for (int c = 0; c < kXC; ++c) {
            const float bv = B_s[(tx + 16 * c) * (kCW + 1) + jj];
            acc[0][c] = fmaf(x0, bv, acc[0][c]);
            acc[1][c] = fmaf(x1, bv, acc[1][c]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kXC; ++c) {
        const int k = tx + 16 * c;
        if (k < K) {
          Y_s[ty * ld + k] = acc[0][c];
          Y_s[(ty + 16) * ld + k] = acc[1][c];
        }
      }
    }
    __syncthreads();
    // dA = 2/nm (A gb - xb), in place of xb; each thread carries kGroup
    // entries side by side
    for (int e0 = 0; e0 < kRT * K; e0 += kGroup * kThreads) {
      int ia[kGroup], ka[kGroup];
      float acc[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int e = min(e0 + t + kThreads * u, kRT * K - 1);
        ia[u] = (e / K) * ld;
        ka[u] = e % K;
        acc[u] = 0.f;
      }
      for (int l = 0; l < K; ++l)
#pragma unroll
        for (int u = 0; u < kGroup; ++u) acc[u] = fmaf(A_s[ia[u] + l], gb_s[l * K + ka[u]], acc[u]);
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int e = e0 + t + kThreads * u;
        if (e < kRT * K) {
          const int o = (e / K) * ld + ka[u];
          Y_s[o] = a.two_nm * (acc[u] - Y_s[o]);
        }
      }
    }
    __syncthreads();
    // coefficient and omega gradients: thread k owns column k
    for (int k = t; k < K; k += kThreads) {
      const int* ck = ct + k * CT;
      const bool trig = ck[1] != 0;
      const int lane = ck[2], q = ck[3];
      float gc = cacc[k];
      float go = trig ? oacc[q] : 0.f;
      for (int i = 0; i < rows; ++i) {
        const float da = Y_s[i * ld + k];
        gc = fmaf(da, D_s[i * ld + k], gc);
        if (trig) go = fmaf(da * c_s[k] * V_s[i * ld + k], aug_s[i * AW + lane], go);
      }
      cacc[k] = gc;
      if (trig) oacc[q] = go;
    }
    // dl[row][j]: the trig part through omega, the polynomial part by the
    // product rule over the factors of every column that holds lane j + 1
    for (int e = t; e < rows * r; e += kThreads) {
      const int i = e / r, j = e % r;
      const float* ag = aug_s + i * AW;
      float trig = 0.f;
      for (int kind = 0; kind < 3; ++kind) {
        const int q = kind * r + j, k = T + q;
        trig += Y_s[i * ld + k] * c_s[k] * V_s[i * ld + k] * om_s[q];
      }
      float poly = 0.f;
      for (int tt = 0; tt < T; ++tt)
        for (int q = 0; q < P; ++q) {
          if (ct[tt * CT + kCT + q] != j + 1) continue;
          float prod = Y_s[i * ld + tt] * c_s[tt];
          for (int u = 0; u < P; ++u)
            if (u != q) prod *= ag[ct[tt * CT + kCT + u]];
          poly += prod;
        }
      a.dl[(long long)(r0 + i) * r + j] = trig + poly;
    }
    // Gram partials over the tile's rows: AᵀA, kGroup entries side by side,
    // and latᵀlat
    for (int e0 = 0; e0 < kk; e0 += kGroup * kThreads) {
      int k1[kGroup], k2[kGroup];
      float g[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int e = min(e0 + t + kThreads * u, kk - 1);
        k1[u] = e / K;
        k2[u] = e % K;
        g[u] = part_ga[e];
      }
      for (int i = 0; i < rows; ++i)
#pragma unroll
        for (int u = 0; u < kGroup; ++u) g[u] = fmaf(A_s[i * ld + k1[u]], A_s[i * ld + k2[u]], g[u]);
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
        if (e0 + t + kThreads * u < kk) part_ga[e0 + t + kThreads * u] = g[u];
    }
    for (int e = t; e < r * r; e += kThreads) {
      const int j1 = e / r, j2 = e % r;
      float g = part_lat[e];
      for (int i = 0; i < rows; ++i) g = fmaf(aug_s[i * AW + 1 + j1], aug_s[i * AW + 1 + j2], g);
      part_lat[e] = g;
    }
  }
  __syncthreads();
  for (int k = t; k < K; k += kThreads) part[kk + r * r + k] = cacc[k];
  for (int q = t; q < 3 * r; q += kThreads) part[kk + r * r + K + q] = oacc[q];
  vmax = block_max(vmax, red);
  if (t == 0) a.work[L.part_max + b] = vmax;
}

// Phase 2, columns: ax = AᵀX over the block's slab of columns, in sub-slabs
// of kSW columns.
template <int KP>
__device__ void column_phase(const Args& a, const Layout& L, float* smem) {
  constexpr int kRT3 = ax_tile_rows(KP);
  constexpr int kKq = (KP + 31) / 32;              // lane owns k = lane + 32q, q < kKq
  constexpr int kPrefA3 = kRT3 * KP / kThreads;    // A values prefetched per thread
  constexpr int kPrefX3 = kRT3 * kSW / kThreads;   // X values prefetched per thread
  const int t = threadIdx.x, b = blockIdx.x, G = gridDim.x;
  const int n = a.n, m = a.m, K = a.K;
  const float* A_g = a.work + L.a;
  float* As = smem;                    // lanes with k >= K read past the tile and are dropped
  float* Xs = As + kRT3 * K + KP;      // 16-byte aligned: rows are read as float4
  float* wred = Xs + kRT3 * kSW;
  const int W = (m + G - 1) / G, col_begin = b * W, col_end = min(m, col_begin + W);
  const int lane = t % 32, warp = t / 32;
  for (int j0 = col_begin; j0 < col_end; j0 += kSW) {
    const int w = min(kSW, col_end - j0);
    // lane owns k = lane + 32q and all kSW columns, warp owns the rows of each
    // staged tile that are warp mod kWarps; the next tile of A and X is
    // loaded into registers while this one is used. Each tile's sum is
    // formed on its own and then added to the running one, so no chain of
    // additions is longer than a tile's rows per warp plus the tile count:
    // the dictionary's constant column sums X's columns, whose terms cancel,
    // and a chain over all rows loses digits there (cuBLAS's float32 AᵀX is
    // 6.4e-6 of max|AᵀX| from float64 at the cylinder's shape; this 1.6e-6).
    float acc[kKq][kSW];
#pragma unroll
    for (int q = 0; q < kKq; ++q)
#pragma unroll
      for (int jj = 0; jj < kSW; ++jj) acc[q][jj] = 0.f;
    float pa[kPrefA3], px[kPrefX3];
    auto fetch = [&](int i0) {
      const int rows = min(kRT3, n - i0);
      const float* src = A_g + (long long)i0 * K;  // the tile's rows of A are contiguous
#pragma unroll
      for (int u = 0; u < kPrefA3; ++u) {
        const int e = t + kThreads * u;
        pa[u] = e < rows * K ? src[e] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kPrefX3; ++u) {
        const int e = t + kThreads * u, i = e / kSW, jj = e % kSW;
        px[u] = (i < rows && jj < w) ? a.x[(long long)(i0 + i) * m + j0 + jj] : 0.f;
      }
    };
    fetch(0);
    for (int i0 = 0; i0 < n; i0 += kRT3) {
      const int rows = min(kRT3, n - i0);
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kPrefA3; ++u) {
        const int e = t + kThreads * u;
        if (e < kRT3 * K + KP) As[e] = pa[u];
      }
#pragma unroll
      for (int u = 0; u < kPrefX3; ++u) Xs[t + kThreads * u] = px[u];
      __syncthreads();
      if (i0 + kRT3 < n) fetch(i0 + kRT3);
      float tile[kKq][kSW];
#pragma unroll
      for (int q = 0; q < kKq; ++q)
#pragma unroll
        for (int jj = 0; jj < kSW; ++jj) tile[q][jj] = 0.f;
      for (int i = warp; i < rows; i += kWarps) {
        const float4 lo = reinterpret_cast<const float4*>(Xs + i * kSW)[0];
        const float4 hi = reinterpret_cast<const float4*>(Xs + i * kSW)[1];
        const float xv[kSW] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int q = 0; q < kKq; ++q) {
          const float av = As[i * K + lane + 32 * q];
#pragma unroll
          for (int jj = 0; jj < kSW; ++jj) tile[q][jj] = fmaf(av, xv[jj], tile[q][jj]);
        }
      }
#pragma unroll
      for (int q = 0; q < kKq; ++q)
#pragma unroll
        for (int jj = 0; jj < kSW; ++jj) acc[q][jj] += tile[q][jj];
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kKq; ++q) {
      const int k = lane + 32 * q;
      if (k < K)
#pragma unroll
        for (int jj = 0; jj < kSW; ++jj) wred[(warp * K + k) * kSW + jj] = acc[q][jj];
    }
    __syncthreads();
    for (int o = t; o < K * kSW; o += kThreads) {
      const int k = o / kSW, jj = o % kSW;
      if (jj >= w) continue;
      float sum = 0.f;
      for (int ww = 0; ww < kWarps; ++ww) sum += wred[ww * K * kSW + o];  // in warp order
      a.sums[(long long)k * m + j0 + jj] = sum;
    }
  }
}

template <int KP>
__global__ void __launch_bounds__(kThreads, 1) step_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  const Layout L = make_layout(a.n, a.r, a.K, gridDim.x);
  const int CT = kCT + a.P;
  int* ct = reinterpret_cast<int*>(shared_base());
  for (int e = threadIdx.x; e < a.K * CT; e += kThreads) ct[e] = a.ctab[e];
  __syncthreads();
  float* smem = shared_base() + round4(a.K * CT);
  row_phase<KP>(a, L, ct, smem);
  grid.sync();
  reduce_partials(a.work + L.part, L.es, L.es, a.sums + (long long)a.K * a.m, smem);
  if (blockIdx.x == 0) {
    float v = 0.f;
    for (int bb = threadIdx.x; bb < (int)gridDim.x; bb += kThreads) v = max_nan(v, a.work[L.part_max + bb]);
    v = block_max(v, smem);
    if (threadIdx.x == 0) a.max_arg[0] = v;
  }
  column_phase<KP>(a, L, smem);
}

size_t smem_bytes(int r, int K, int P) { return sizeof(float) * (size_t)smem_floats(r, K, P); }

using KernelFn = void (*)(Args);

KernelFn kernel_for(int K) {
  switch (padded_k(K)) {
    case 32: return step_kernel<32>;
    case 48: return step_kernel<48>;
    case 64: return step_kernel<64>;
    default: return step_kernel<128>;
  }
}

bool valid_shape(int r, int P, int K) {
  return r >= 1 && r <= kMaxR && P >= 1 && P <= kMaxP && K > 3 * r && K <= kMaxK;
}

}  // namespace

extern "C" {

// Blocks of the cooperative launch on the current device (one per SM), or a
// negative cudaError_t: cooperative launch unsupported, or no block fits.
int desmo_step_grid(int r, int P, int K) {
  if (!valid_shape(r, P, K)) return -(int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return -(int)err;
  if (!coop) return -(int)cudaErrorNotSupported;
  const size_t bytes = smem_bytes(r, K, P);
  const void* kernel = (const void*)kernel_for(K);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes);
  if (err != cudaSuccess) return -(int)err;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  return sms;
}

// Floats of scratch the launch needs for n rows and a grid of `grid` blocks.
long long desmo_step_workspace(int n, int r, int K, int grid) { return make_layout(n, r, K, grid).total; }

// One step's partials over this rank's n rows (see the top of this file);
// n_total is the global row count of the normalisation 2 / (n_total m).
// ctab is the (K, kCT + P) column table of one seed. Returns a cudaError_t.
int desmo_step_partials(const float* pod, const float* x, const float* phi, const float* b, const float* gb,
                        const float* coef, const float* omega, const int* ctab, float* dl, float* sums,
                        float* max_arg, float* work, int n, int m, int r, int P, int K, int n_total, int grid,
                        void* stream) {
  if (!valid_shape(r, P, K) || n < 1 || m < 1 || n_total < n || grid < 1) return (int)cudaErrorInvalidValue;
  Args args{pod, x, phi, b, gb, coef, omega, ctab, dl, sums, max_arg, work,
            n, m, r, P, K, (float)(2.0 / ((double)n_total * m))};
  const size_t bytes = smem_bytes(r, K, P);
  const void* kernel = (const void*)kernel_for(K);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), params, bytes,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
