// Fused dual contraction for the factored DESMO loss: one pass over X gives
//
//     ax = Aᵀ X   (K, m)        xb = X Bᵀ   (n, K)
//
// for A (n, K), B (K, m), X (n, m), all fp32 and row-major contiguous.
//
// Replaces the TPU kernels desmo_tpu/pallas/dual_gemm.py::_dual_kernel_split
// (the one on the cylinder training path, over X pre-split into bf16 hi/lo
// planes) and ::_dual_kernel (the same products over unsplit X). The hi/lo
// split existed only because the TPU's matrix unit has no fp32 mode. Here the
// products use plain fp32 FMA with fp32 accumulation, which meets the same
// fp32-grade contract (about 5e-6 relative on the X-cancellation terms)
// without splitting X, so the caller hands the kernel fp32 X as it is.
//
// Bound on an H100 SXM at the cylinder shape (n=3961, m=1001, K=47): one call
// does 2 products x 2 x n*m*K = 0.75 GFLOP, about 11 us at the 67 TFLOP/s
// fp32 rate outside the tensor cores, and reads X (15.9 MB) once, about
// 4.7 us at 3.35 TB/s. An fp32-FMA kernel is therefore compute-bound.
//
// Design (simple first; wgmma/TMA and 3xTF32 are later work):
//   * one block per (tile of kRows rows, split of the columns) of X; it keeps
//     its rows of A in shared memory and walks its columns in chunks of kCols,
//     staging each X chunk with the matching (K, kCols) slice of B in shared
//     memory. The columns are split only as far as it takes to put about
//     kBlocksPerSM blocks on every SM (n/kRows tiles alone leave the card
//     under one block of four warps per SM, which measured 3x slower);
//   * from each staged chunk it accumulates its rows of xb in registers over
//     its columns, and forms the chunk's partial Aᵀ X over its own rows;
//   * the partials (ax: n_tiles x (K, m); xb: n_splits x (n, K)) go to
//     scratch buffers and a second kernel sums each in a fixed order, so two
//     runs give identical bits, as the TPU's sequential grid does;
//   * ragged n and m, and K below its padded width kKP, are masked here:
//     the caller pads nothing.
//   The kernels launch on the caller's stream, allocate nothing and do not
//   synchronise; the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kRows = 32;     // rows of X per block
constexpr int kCols = 32;     // columns of X per staged chunk
constexpr int kThreads = 128; // 8 x 16 thread grid
constexpr int kMaxK = 128;  // the packed width the TPU kernel serves in one 128-lane block
constexpr int kBlocksPerSM = 4;

// kKP: K padded to 16, 32, 48, 64 or 128 (128: the packed width of the
// seed-packed loss). At 128 a thread carries 4 x 8 xb and 16 x 2 ax
// accumulators; ptxas reports 79 registers, no spill and 37,504 bytes of
// shared memory for sm_90a (chip_smoke.py phase 2 prints its report).
template <int kKP>
__global__ void __launch_bounds__(kThreads)
dual_tile_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ x, float* __restrict__ ax_part,
                 float* __restrict__ xb_part, int n, int m, int k, int split_cols) {
  // +1 column on the staged tiles keeps the column walks free of bank conflicts
  __shared__ float As[kRows][kKP];
  __shared__ float Xs[kRows][kCols + 1];
  __shared__ float Bs[kKP][kCols + 1];

  constexpr int kXbK = kKP / 16;  // xb: rows ty + 8r (r < 4), k = tx + 16c (c < kXbK)
  constexpr int kAxK = kKP / 8;   // ax: k = ty + 8r (r < kAxK), cols tx + 16c (c < 2)

  const int t = threadIdx.x;
  const int ty = t / 16;  // 0..7
  const int tx = t % 16;  // 0..15
  const int tile = blockIdx.x;
  const int row0 = tile * kRows;
  const int col_begin = blockIdx.y * split_cols;
  const int col_end = min(m, col_begin + split_cols);

  for (int e = t; e < kRows * kKP; e += kThreads) {
    const int i = e / kKP, kk = e % kKP;
    const int row = row0 + i;
    As[i][kk] = (row < n && kk < k) ? a[(size_t)row * k + kk] : 0.f;
  }

  float xb_acc[4][kXbK];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kXbK; ++c) xb_acc[r][c] = 0.f;

  float* part = ax_part + (size_t)tile * k * m;

  for (int j0 = col_begin; j0 < col_end; j0 += kCols) {
    __syncthreads();  // the previous chunk is consumed (and As is ready)
    for (int e = t; e < kRows * kCols; e += kThreads) {
      const int i = e / kCols, jj = e % kCols;
      const int row = row0 + i, col = j0 + jj;
      Xs[i][jj] = (row < n && col < m) ? x[(size_t)row * m + col] : 0.f;
    }
    for (int e = t; e < kKP * kCols; e += kThreads) {
      const int kk = e / kCols, jj = e % kCols;
      const int col = j0 + jj;
      Bs[kk][jj] = (kk < k && col < m) ? b[(size_t)kk * m + col] : 0.f;
    }
    __syncthreads();

    // xb[row, kk] += sum_jj X[row, jj] * B[kk, jj]
#pragma unroll 4
    for (int jj = 0; jj < kCols; ++jj) {
      float xv[4], bv[kXbK];
#pragma unroll
      for (int r = 0; r < 4; ++r) xv[r] = Xs[ty + 8 * r][jj];
#pragma unroll
      for (int c = 0; c < kXbK; ++c) bv[c] = Bs[tx + 16 * c][jj];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < kXbK; ++c) xb_acc[r][c] = fmaf(xv[r], bv[c], xb_acc[r][c]);
    }

    // this tile's share of ax[kk, col] = sum_i A[i, kk] * X[i, col]
    float ax_acc[kAxK][2];
#pragma unroll
    for (int r = 0; r < kAxK; ++r) ax_acc[r][0] = ax_acc[r][1] = 0.f;
#pragma unroll 4
    for (int i = 0; i < kRows; ++i) {
      const float x0 = Xs[i][tx];
      const float x1 = Xs[i][tx + 16];
#pragma unroll
      for (int r = 0; r < kAxK; ++r) {
        const float av = As[i][ty + 8 * r];
        ax_acc[r][0] = fmaf(av, x0, ax_acc[r][0]);
        ax_acc[r][1] = fmaf(av, x1, ax_acc[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < kAxK; ++r) {
      const int kk = ty + 8 * r;
      if (kk >= k) continue;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = j0 + tx + 16 * c;
        if (col < m) part[(size_t)kk * m + col] = ax_acc[r][c];
      }
    }
  }

  float* xb_out = xb_part + (size_t)blockIdx.y * n * k;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + ty + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < kXbK; ++c) {
      const int kk = tx + 16 * c;
      if (kk < k) xb_out[(size_t)row * k + kk] = xb_acc[r][c];
    }
  }
}

// out[idx] = sum over parts, in part order, of parts[part, idx].
__global__ void __launch_bounds__(256)
reduce_parts_kernel(const float* __restrict__ parts, float* __restrict__ out,
                    int n_parts, int count) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= count) return;
  float s = 0.f;
  for (int p = 0; p < n_parts; ++p) s += parts[(size_t)p * count + idx];
  out[idx] = s;
}

template <int kKP>
void launch_tiles(const float* a, const float* b, const float* x, float* ax_part,
                  float* xb_part, int n, int m, int k, dim3 grid, int split_cols,
                  cudaStream_t s) {
  dual_tile_kernel<kKP><<<grid, kThreads, 0, s>>>(a, b, x, ax_part, xb_part, n, m, k,
                                                   split_cols);
}

int column_chunks(int m) { return (m + kCols - 1) / kCols; }

}  // namespace

extern "C" {

// Rows of X per tile: ax's scratch holds ceil(n / tile_rows) (K, m) partials.
int desmo_dual_tile_rows(void) { return kRows; }

// Largest K the kernel takes.
int desmo_dual_max_k(void) { return kMaxK; }

// Column splits for an (n, m) X on the current device: xb's scratch holds
// this many (n, K) partials. Returns a negative cudaError_t on failure.
int desmo_dual_splits(int n, int m) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  const int n_tiles = (n + kRows - 1) / kRows;
  const int chunks = column_chunks(m);
  int splits = (kBlocksPerSM * sms + n_tiles - 1) / n_tiles;
  splits = splits < 1 ? 1 : (splits > chunks ? chunks : splits);
  const int per_split = (chunks + splits - 1) / splits;
  return (chunks + per_split - 1) / per_split;  // no empty split
}

// ax_part: ceil(n / tile_rows) * k * m floats; xb_part: n_splits * n * k
// floats, n_splits from desmo_dual_splits(n, m). Returns a cudaError_t.
int desmo_dual_contractions(const float* a, const float* b, const float* x,
                            float* ax_part, float* xb_part, float* ax, float* xb,
                            int n, int m, int k, int n_splits, void* stream) {
  if (n <= 0 || m <= 0 || k <= 0 || k > kMaxK || n_splits <= 0 ||
      n_splits > column_chunks(m))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (n + kRows - 1) / kRows;
  const int split_cols = (column_chunks(m) + n_splits - 1) / n_splits * kCols;
  const dim3 grid(n_tiles, n_splits);
  if (k <= 16) {
    launch_tiles<16>(a, b, x, ax_part, xb_part, n, m, k, grid, split_cols, s);
  } else if (k <= 32) {
    launch_tiles<32>(a, b, x, ax_part, xb_part, n, m, k, grid, split_cols, s);
  } else if (k <= 48) {
    launch_tiles<48>(a, b, x, ax_part, xb_part, n, m, k, grid, split_cols, s);
  } else if (k <= 64) {
    launch_tiles<64>(a, b, x, ax_part, xb_part, n, m, k, grid, split_cols, s);
  } else {
    launch_tiles<128>(a, b, x, ax_part, xb_part, n, m, k, grid, split_cols, s);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int km = k * m, nk = n * k;
  reduce_parts_kernel<<<(km + 255) / 256, 256, 0, s>>>(ax_part, ax, n_tiles, km);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_parts_kernel<<<(nk + 255) / 256, 256, 0, s>>>(xb_part, xb, n_splits, nk);
  return (int)cudaGetLastError();
}

}  // extern "C"
