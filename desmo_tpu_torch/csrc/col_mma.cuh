// Tensor-core tiles over the row index, for kernels of 256 threads: the
// column products C = Lᵀ R (L, R row-major over the same rows, so the rows
// are the mma's k dimension) that the AE kernel and the dual contraction
// form, and the fragment loads they and X·Bᵀ tiles need. Built on
// tile_mma.cuh (3xTF32 mma.sync m16n8k8, cp.async), whose primitives this
// header leaves as they are.
//
// What bounds such tiles on the H100 is their instruction stream, the
// fragment loads and TF32 splits, more than their products (measured on the
// mega-kernel's tiles). So here:
//   * every operand is split into its big and small TF32 planes once, in
//     shared memory, by the thread that copied it (after its own cp.async
//     lands and before the stage's barrier); a fragment load is then two
//     plain shared loads and no arithmetic;
//   * each warp forms 2 m16 x 4-8 n8 tiles, so one fragment serves several
//     products;
//   * stages of kColRows rows pass through a ring of kColStages stages filled
//     kColStages - 1 stages ahead by cp.async: 16-byte copies where the
//     operand's rows are 16-byte aligned, else 4-byte ones;
//   * the planes' row strides are 8 mod 32 floats (A and B fragments loaded
//     along the row index) or 4 mod 32 (loaded along the columns), so a
//     warp's fragment loads hit 32 distinct banks.
//
// A host build for the emulated grid (DESMO_EMULATED_GRID) takes cp_async4
// from its stand-in headers, as it takes tile_mma.cuh's primitives.
#pragma once

#include "tile_mma.cuh"

#ifndef DESMO_EMULATED_GRID
// A 4-byte cp.async (through L1); zero-fills when !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
#endif

// The fragments below read planes split beforehand: the big TF32 parts at
// pb, the small ones at ps, both laid out alike.

// The A fragment of the 16 x 8 block whose (row, col) entry is p[row * ld + col].
__device__ __forceinline__ void load_a_rows_split(const float* pb, const float* ps, int ld, unsigned* big,
                                                  unsigned* small) {
  const int g = (threadIdx.x % 32) >> 2, q = threadIdx.x & 3;
  const int o[4] = {g * ld + q, (g + 8) * ld + q, g * ld + q + 4, (g + 8) * ld + q + 4};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    big[e] = u32_bits(pb[o[e]]);
    small[e] = u32_bits(ps[o[e]]);
  }
}

// The B fragment of the 8 x 8 block whose (k, col) entry is p[k * ld + col].
__device__ __forceinline__ void load_b_rows_split(const float* pb, const float* ps, int ld, unsigned* big,
                                                  unsigned* small) {
  const int g = (threadIdx.x % 32) >> 2, q = threadIdx.x & 3;
  big[0] = u32_bits(pb[q * ld + g]);
  small[0] = u32_bits(ps[q * ld + g]);
  big[1] = u32_bits(pb[(q + 4) * ld + g]);
  small[1] = u32_bits(ps[(q + 4) * ld + g]);
}

// The B fragment of the 8 x 8 block whose (k, col) entry is p[col * ld + k].
__device__ __forceinline__ void load_b_cols_split(const float* pb, const float* ps, int ld, unsigned* big,
                                                  unsigned* small) {
  const int g = (threadIdx.x % 32) >> 2, q = threadIdx.x & 3;
  big[0] = u32_bits(pb[g * ld + q]);
  small[0] = u32_bits(ps[g * ld + q]);
  big[1] = u32_bits(pb[g * ld + q + 4]);
  small[1] = u32_bits(ps[g * ld + q + 4]);
}

// A row-major (rows, width) operand at stride ld floats; p == nullptr
// stands for a column of ones (width 1). aligned: 16-byte rows (ld a
// multiple of 4 and p 16-byte aligned), so that a piece of four floats that
// starts below width lies within its row.
struct ColOperand {
  const float* p;
  long long ld;
  int width;
  bool aligned;
};

__host__ __device__ inline bool rows_aligned(const float* p, long long ld) {
  return ld % 4 == 0 && ((unsigned long long)p & 15) == 0;
}

__host__ __device__ inline ColOperand col_operand(const float* p, long long ld, int width) {
  return ColOperand{p, ld, width, p && rows_aligned(p, ld)};
}

// Copies the four floats at src into dst (16-byte aligned), the first
// `valid` of them (0 to 4) from src and the rest as zero; src must be a
// readable address even when valid == 0. Aligned rows take one 16-byte copy
// (every float of a piece that starts in range lies in its row).
__device__ __forceinline__ void stage4(float* dst, const float* src, int valid, bool aligned) {
  if (aligned) {
    cp_async16(dst, src, valid > 0);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) cp_async4(dst + e, valid > e ? src + e : src, valid > e);
  }
}

// Splits four staged floats (16-byte aligned) in place: big parts stay at
// pb, small parts go to ps. One 16-byte load and two 16-byte stores: a
// warp's pieces lie 16 bytes apart, which scalar accesses would take in
// four-way bank conflicts.
__device__ __forceinline__ void split4(float* pb, float* ps) {
  float4 v = *reinterpret_cast<const float4*>(pb), big4, small4;
  unsigned big, small;
  split_tf32(v.x, big, small);
  big4.x = f32_bits(big);
  small4.x = f32_bits(small);
  split_tf32(v.y, big, small);
  big4.y = f32_bits(big);
  small4.y = f32_bits(small);
  split_tf32(v.z, big, small);
  big4.z = f32_bits(big);
  small4.z = f32_bits(small);
  split_tf32(v.w, big, small);
  big4.w = f32_bits(big);
  small4.w = f32_bits(small);
  *reinterpret_cast<float4*>(pb) = big4;
  *reinterpret_cast<float4*>(ps) = small4;
}

// acc[i][j] += a[i] b[j] at fp32 grade for a warp's M x N grid of tiles
// (fragments split beforehand; a tile is formed where aon[i] and bon[j]).
// The three TF32 passes go pass by pass over the whole grid, so that
// consecutive products feed different accumulators and the tensor cores
// need not wait for one to finish; each accumulator still takes its small
// terms first, as mma_3xtf32 orders them.
template <int M, int N>
__device__ __forceinline__ void mma_3xtf32_grid(float (&acc)[M][N][4], const unsigned (&a_big)[M][4],
                                                const unsigned (&a_small)[M][4], const unsigned (&b_big)[N][2],
                                                const unsigned (&b_small)[N][2], const bool (&aon)[M],
                                                const bool (&bon)[N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (aon[i] && bon[j]) mma_tf32(acc[i][j], a_small[i], b_big[j]);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (aon[i] && bon[j]) mma_tf32(acc[i][j], a_big[i], b_small[j]);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (aon[i] && bon[j]) mma_tf32(acc[i][j], a_big[i], b_big[j]);
}

constexpr int kColThreads = 256;
constexpr int kColRows = 32;   // rows per stage: four k8 steps
constexpr int kColTQ = 128;    // output columns (of R) per tile
constexpr int kColStages = 3;  // stages in the cp.async ring, by default
__host__ __device__ constexpr int col_ld_l(int TP) { return TP + 8; }
__host__ __device__ constexpr int col_ld_r() { return kColTQ + 8; }
// shared floats of lt_r_tile<TP, S>'s ring
__host__ __device__ constexpr int col_ring_floats(int TP, int S = kColStages) {
  return S * 2 * kColRows * (col_ld_l(TP) + col_ld_r());
}

// out[(p - p0) * ldo + q - q0] = sum over the rows i in [i0, i1) of
// L(i, p) R(i, q), for p in [p0, p0 + TP) below L's width (1 for the ones
// column) and q in [q0, q0 + kColTQ) below R's width: one output tile of Lᵀ R
// in 3xTF32 tiles (fp32 grade; see tile_mma.cuh), through a ring of S
// stages. TP = 64 or 128. The 8
// warps form a (TP / 32) x (8 / (TP / 32)) grid over the tile, each warp
// 2 m16 tiles of p by 4 (TP = 64) or 8 (TP = 128) n8 tiles of q. Each
// stage's sum is formed in fresh accumulators and then added to the running
// one: the tensor cores' own additions are not rounded to nearest, and a
// chain of them through all the rows drifts (about 4e-6 of max|ref| over
// 3,961 rows on the H100, against 3e-7 so). Rows beyond i1 are zero in the
// ring. An empty row range stores zeros. Every thread of the block must
// call it.
template <int TP, int S = kColStages>
__device__ void lt_r_tile(const ColOperand L, const ColOperand R, int i0, int i1, int p0, int q0, float* ring,
                          float* out, long long ldo) {
  constexpr int RS = kColRows, LDL = col_ld_l(TP), LDR = col_ld_r();
  constexpr int kStage = 2 * RS * (LDL + LDR);  // L's big and small planes, then R's
  constexpr int LPR = TP / 4, LRS = kColThreads / LPR;        // L: pieces a row, rows a pass
  constexpr int RPR = kColTQ / 4, RRS = kColThreads / RPR;    // R: the same
  constexpr int WP = TP / 32, WQ = 8 / WP, QW = kColTQ / WQ, NQ = QW / 8;
  static_assert(TP == 64 || TP == 128, "tile heights");
  static_assert(RS % LRS == 0 && RS % RRS == 0, "a stage is copied in whole passes");
  const int t = threadIdx.x, warp = t / 32, wp = warp % WP, wq = warp / WP;
  const int nrows = i1 > i0 ? i1 - i0 : 0, ntile = (nrows + RS - 1) / RS;
  const int pw = L.p ? L.width : 1, qw = R.width;
  const int lc = 4 * (t % LPR), lr = t / LPR, rc = 4 * (t % RPR), rr = t / RPR;
  const int lval = L.p ? min(4, max(0, pw - p0 - lc)) : 0, rval = min(4, max(0, qw - q0 - rc));
  const float* lsrc = L.p ? L.p + (long long)(i0 + lr) * L.ld + p0 + lc : nullptr;
  const float* rsrc = R.p + (long long)(i0 + rr) * R.ld + q0 + rc;

  auto issue = [&](int tile) {
    float* st = ring + (tile % S) * kStage;
    float* lb = st + lr * LDL + lc;
    float* rb = st + 2 * RS * LDL + rr * LDR + rc;
    const int base = tile * RS;
#pragma unroll
    for (int u = 0; u < RS / LRS; ++u) {
      const bool ok = base + lr + LRS * u < nrows;
      if (L.p) {
        const int v = ok ? lval : 0;
        stage4(lb + LRS * LDL * u, v > 0 ? lsrc + (long long)(base + LRS * u) * L.ld : L.p, v, L.aligned);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) lb[LRS * LDL * u + e] = ok && p0 + lc + e == 0 ? 1.f : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < RS / RRS; ++u) {
      const int v = base + rr + RRS * u < nrows ? rval : 0;
      stage4(rb + RRS * LDR * u, v > 0 ? rsrc + (long long)(base + RRS * u) * R.ld : R.p, v, R.aligned);
    }
  };

  // this warp's tiles: m16 tiles at p pm0 + 16 mt, n8 tiles at q qn0 + 8 j (in the tile)
  const int pm0 = wp * 32, qn0 = wq * QW;
  bool aon[2], bon[NQ];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) aon[mt] = p0 + pm0 + 16 * mt < pw;
#pragma unroll
  for (int j = 0; j < NQ; ++j) bon[j] = q0 + qn0 + 8 * j < qw;
  float run[2][NQ][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) run[mt][j][e] = 0.f;
  __syncthreads();  // the ring's previous use is over
  for (int c = 0; c < S - 1; ++c) {
    if (c < ntile) issue(c);
    cp_async_commit();
  }
  for (int tile = 0; tile < ntile; ++tile) {
    cp_async_wait<S - 2>();
    {  // this thread's own pieces of the stage have landed: split them in place
      float* st = ring + (tile % S) * kStage;
      float* lb = st + lr * LDL + lc;
      float* rb = st + 2 * RS * LDL + rr * LDR + rc;
#pragma unroll
      for (int u = 0; u < RS / LRS; ++u) split4(lb + LRS * LDL * u, lb + RS * LDL + LRS * LDL * u);
#pragma unroll
      for (int u = 0; u < RS / RRS; ++u) split4(rb + RRS * LDR * u, rb + RS * LDR + RRS * LDR * u);
    }
    __syncthreads();  // the stage is in every thread's view, and the previous stage is free
    if (tile + S - 1 < ntile) issue(tile + S - 1);
    cp_async_commit();
    const float* lb = ring + (tile % S) * kStage;
    const float* ls = lb + RS * LDL;
    const float* rb = ls + RS * LDL;
    const float* rs = rb + RS * LDR;
    float acc[2][NQ][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
#pragma unroll
    for (int s = 0; s < RS / 8; ++s) {
      unsigned a_big[2][4], a_small[2][4], b_big[NQ][2], b_small[NQ][2];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
        if (bon[j]) load_b_rows_split(rb + 8 * s * LDR + qn0 + 8 * j, rs + 8 * s * LDR + qn0 + 8 * j, LDR, b_big[j],
                                      b_small[j]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        if (aon[mt])
          load_a_cols_split(lb + 8 * s * LDL + pm0 + 16 * mt, ls + 8 * s * LDL + pm0 + 16 * mt, LDL, a_big[mt],
                            a_small[mt]);
      mma_3xtf32_grid(acc, a_big, a_small, b_big, b_small, aon, bon);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) run[mt][j][e] += acc[mt][j][e];
  }
  cp_async_wait<0>();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int pm = wp * 32 + 16 * mt, qn = wq * QW + 8 * j;
      const int rows = pw - p0 - pm, cols = qw - q0 - qn;
      if (rows > 0 && cols > 0) store_c(run[mt][j], out + pm * ldo + qn, (int)ldo, rows, cols);
    }
}
