// Warp tiles for Hopper's tensor cores at fp32 grade, and asynchronous
// staging into shared memory. Included by the kernels of this directory.
//
// Products: mma.sync.aligned.m16n8k8 with TF32 operands and fp32
// accumulators, three passes per tile (3xTF32). Each fp32 operand x splits
// into a TF32 big part b, x rounded to 11 significant bits by Veltkamp's
// split (b = c - (c - x) with c = (2^13 + 1) x: exact, NaN and Inf pass),
// and a small part s = x - b (exact, at most 2^-12 |x|) rounded to TF32. A
// product is taken as as*bb + ab*bs + ab*bb (small terms first), which
// drops only s*s and the rounding of s: about 2^-23 of |a b| per product,
// against 2^-24 for an fp32 FMA. Single-pass TF32 (2^-11) would not keep
// the fp32-grade accuracy the contractions with X need (their terms
// cancel). The split takes four full-rate arithmetic instructions and two
// integer ones; two cvt.rna.tf32.f32 took longer on the H100.
//
// Staging: cp.async copies global memory into shared memory without passing
// through registers. A ring of stages is filled a few tiles ahead of the one
// in use (commit_group per stage, wait_group for the oldest), so the L2's
// latency hides behind the tiles' math and no thread holds a prefetch in
// registers. Copies are 16 bytes, so the rows they read must be 16-byte
// aligned (a kernel stages X, whose rows are m floats long, from a padded
// copy); a copy whose source is out of range fills zeros.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32; g = lane / 4, q = lane % 4):
//   A (16 x 8, row major): a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4)
//   B (8 x 8, column major): b0 (q, g), b1 (q + 4, g)
//   C, D (16 x 8): c0 (g, 2q), c1 (g, 2q + 1), c2 (g + 8, 2q), c3 (g + 8, 2q + 1)
//
// The primitives (cp_async16, cp_async_commit, cp_async_wait, fmul_rn,
// fsub_rn, f32_bits, u32_bits, mma_tf32) are PTX or CUDA intrinsics on the
// card. A host build for the emulated grid (DESMO_EMULATED_GRID) takes its
// own definitions of them, with the same semantics, from its stand-in
// headers.
#pragma once

#ifndef DESMO_EMULATED_GRID
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// waits until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rounded fp32 product and difference, never fused into an FMA
__device__ __forceinline__ float fmul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fsub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float f32_bits(unsigned u) { return __uint_as_float(u); }
__device__ __forceinline__ unsigned u32_bits(float x) { return __float_as_uint(x); }

// d += a b for one 16 x 8 x 8 tile of the warp (fragments as above). Not
// volatile: the compiler may interleave independent tiles' products.
__device__ __forceinline__ void mma_tf32(float* d, const unsigned* a, const unsigned* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#endif

// x = big + small (to 2^-23 |x|), both TF32; see above
__device__ __forceinline__ void split_tf32(float x, unsigned& big, unsigned& small) {
  const float c = fmul_rn(x, 8193.f);
  const float hi = fsub_rn(c, fsub_rn(c, x));
  big = u32_bits(hi);
  small = (u32_bits(fsub_rn(x, hi)) + 0x1000u) & 0xffffe000u;  // to nearest, ties away from zero
}

// d += a b at fp32 grade: the three passes, small terms first
__device__ __forceinline__ void mma_3xtf32(float* d, const unsigned* a_big, const unsigned* a_small,
                                           const unsigned* b_big, const unsigned* b_small) {
  mma_tf32(d, a_small, b_big);
  mma_tf32(d, a_big, b_small);
  mma_tf32(d, a_big, b_big);
}

// The A fragment of the 16 x 8 block whose (row, col) entry is p[row * ld + col].
__device__ __forceinline__ void load_a_rows(const float* p, int ld, unsigned* big, unsigned* small) {
  const int g = (threadIdx.x % 32) >> 2, q = threadIdx.x & 3;
  split_tf32(p[g * ld + q], big[0], small[0]);
  split_tf32(p[(g + 8) * ld + q], big[1], small[1]);
  split_tf32(p[g * ld + q + 4], big[2], small[2]);
  split_tf32(p[(g + 8) * ld + q + 4], big[3], small[3]);
}

// The A fragment of the 16 x 8 block whose (row, col) entry is x[col * ld +
// row] (the transpose of a row-major tile), from parts split beforehand: the
// big parts of x at pb, the small parts at ps, both laid out so.
__device__ __forceinline__ void load_a_cols_split(const float* pb, const float* ps, int ld, unsigned* big,
                                                  unsigned* small) {
  const int g = (threadIdx.x % 32) >> 2, q = threadIdx.x & 3;
  const int o[4] = {q * ld + g, q * ld + g + 8, (q + 4) * ld + g, (q + 4) * ld + g + 8};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    big[e] = u32_bits(pb[o[e]]);
    small[e] = u32_bits(ps[o[e]]);
  }
}

// The B fragment of the 8 x 8 block whose (k, col) entry is p[col * ld + k].
__device__ __forceinline__ void load_b_cols(const float* p, int ld, unsigned* big, unsigned* small) {
  const int g = (threadIdx.x % 32) >> 2, q = threadIdx.x & 3;
  split_tf32(p[g * ld + q], big[0], small[0]);
  split_tf32(p[g * ld + q + 4], big[1], small[1]);
}

// The B fragment of the 8 x 8 block whose (k, col) entry is p[k * ld + col].
__device__ __forceinline__ void load_b_rows(const float* p, int ld, unsigned* big, unsigned* small) {
  const int g = (threadIdx.x % 32) >> 2, q = threadIdx.x & 3;
  split_tf32(p[q * ld + g], big[0], small[0]);
  split_tf32(p[(q + 4) * ld + g], big[1], small[1]);
}

// Stores the accumulator d of a 16 x 8 tile at out[row * ld + col] for the
// entries with row < rows and col < cols.
__device__ __forceinline__ void store_c(const float* d, float* out, int ld, int rows, int cols) {
  const int g = (threadIdx.x % 32) >> 2, q = threadIdx.x & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * q + (e & 1);
    if (row < rows && col < cols) out[row * ld + col] = d[e];
  }
}
