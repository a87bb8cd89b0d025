// A whole training chunk of DESMO in one cooperative launch: num_steps
// Adamax epochs of the dictionary, the contractions with X, the analytic
// gradients, the plateau scheduler and one metrics row per epoch, for S
// seed-packed models at once (S = 1: one model).
//
// Replaces the TPU kernel desmo_tpu/pallas/train_chunk.py:356 _make_kernel in
// its forms: desmo (resident or streamed transport), Fourier (nf > 0) and
// seed-packed (n_seeds > 1, make_fused_ensemble_chunk), each of the last two
// with the other. The per-epoch semantics are those of the eager training
// step, as desmo_tpu_torch/kernels/train_chunk.py sets them out beside its
// plain PyTorch version.
//
// Bound on an H100 SXM at the cylinder shape (n=3961, m=1001, r=4, P=3, so
// T=35, K=47): an epoch needs about 0.78 GFLOP (AᵀX and XBᵀ 2nmK each, A·gb
// 2nK², ga·B 2K²m, and the symmetric Grams AᵀA nK(K+1) and BBᵀ mK(K+1)) and
// reads X (15.9 MB) once: about 11.6 us at the 67 TFLOP/s fp32 rate outside
// the tensor cores, with the X read (4.7 us at 3.35 TB/s) hidden under it.
// The two contractions with X run on the tensor cores in three TF32 passes
// (3xTF32, tile_mma.cuh): 2 x 3 x 2nmK at 495 TFLOP/s plus the rest at the
// fp32 rate bounds the epoch at about 5.0 us. X (its padded copy) stays in
// the 50 MB L2 from one epoch to the next.
//
// Design. The TPU's sequential grid (num_steps + 1, row tiles) becomes a
// loop inside one persistent cooperative launch of one block per SM; the
// grid size is an argument and every split derives from it. The kernel is
// compiled for K padded to 32, 48, 64 or 128, so its tiles fit K. At the
// launch's start every block copies X (n, m) and B (K, m) into the scratch
// with rows padded to a multiple of 8 floats (zero beyond m), so that the
// contractions stage them by 16-byte copies; the copy of B follows every
// update of B. Per epoch, four phases with a grid-wide barrier after each
// (and one inside the columns phase):
//   1. rows: each block owns a contiguous row range. In tiles of kRT rows it
//      builds lat = pod * phiᵀ, the library D and A = D * c in shared memory,
//      writes A to scratch, forms xb = X Bᵀ for its rows (xb_tile), dA = 2/nm
//      (A gb - xb), the per-row latent gradient dl, and per-block partials of
//      AᵀA, latᵀlat, the coefficient and omega gradients and max |omega * lat|;
//   2. reduce: the partials are summed over the blocks, one warp per entry;
//   3. columns: each block applies the phi Adamax to its own rows (the ortho
//      sign needs the reduced latᵀlat); then ax = Aᵀ X through a 2-D split
//      (ax_partials): the grid is cut into g_r row groups x g_c column slabs,
//      block (i, j) writes the partial Aᵀ X of row group i over slab j to
//      scratch, and after one more grid barrier the owner of each column sums
//      the g_r partials in row-group order. Then for its slab of columns:
//      its share of sum(ax * B), gB = 2/nm (ga B - ax), the B Adamax, and its
//      partial of the next epoch's B Bᵀ;
//   4. finalize: the B Bᵀ partials are summed; block 0 writes the metrics
//      row, steps the coefficient and omega Adamax and the scheduler.
// Every sum across threads or blocks runs in a fixed order, so two launches
// give identical bits. A per-phase clock (PhaseClock) says where the time goes.
//
// The two contractions with X. A slab of AᵀX per block would stream all of A
// back from L2 in every block (G reads of A per epoch: 98 MB at cylinder,
// 1.5 GB at aneurysm with four seeds), and chunks of X and B staged through
// registers one at a time leave the block waiting on L2.
// - AᵀX reads A g_c times per epoch, not G times: g_c is near sqrt(2 G m / n),
//   which balances A's g_c reads against the 2 g_r K m floats of partials
//   (ax_split; at cylinder 16 x 8: A 6 MB, partials 6 MB, X once). A fold of
//   AᵀX into the rows phase (X read once, as the TPU kernel does) would write
//   G partials of K x m (2 x 24.8 MB at cylinder); the split writes g_r.
// - Both stage their tiles through a ring of kStages shared-memory stages
//   filled by 16-byte cp.async copies, kStages - 1 tiles ahead of the one in
//   use: no thread holds a prefetch in registers.
// - The products run on the tensor cores (mma.sync m16n8k8, 3xTF32: fp32
//   grade, see tile_mma.cuh), each fragment loaded once from shared memory
//   for several tiles, the layouts padded so that a warp's fragment loads hit
//   32 distinct banks. X·Bᵀ splits its columns over the warps and adds the
//   warps' sums in warp order; AᵀX gives each warp its own n8 tiles of the
//   slab, sums each staged tile of rows on its own and adds it to the
//   running sum, so no chain of additions is longer than about a hundred.
// What bounds them now (measured on the H100 at cylinder): the staging alone
// takes about 8 us of each, the fragment loads, TF32 splits and products
// the rest; removing the products alone saves little. A's fragments are
// read by every warp, so the thread that copies a piece of A splits it once
// per tile. wgmma (64-row warpgroup tiles) and TMA are not used.
//
// The TPU's bf16 hi/lo three-pass products become TF32 ones; its 128-lane
// AUG/WIDE packing, selection matmuls and gathers, VMEM budgets and fast
// sin/cos do not carry over. Trig is CUDA's full-range sincosf/tanhf (no fast math); the
// polynomial backward uses the product rule over the P factors, so it needs
// no guard at lat == 0. The kernel allocates nothing and does not
// synchronise; the entry point returns the launch's cudaError_t.
//
// The Fourier form (a template parameter, so the desmo form's code is as it
// was; its fields sit at the end of Args, since placing them among the desmo
// form's slowed that form, which runs near its register limit). B (K, m) is
// no parameter there but the truncated series of each row,
// B[k][j] = z_k0 + sum_h z_k,2h-1 cos(h th) + z_k,2h sin(h th) with
// th = 2 pi t_j / period_k, built as the TPU kernel builds it: cos and sin of
// th once (sincosf, full range: th reaches about 1e3 rad), the harmonics by
// the recurrence cos((h+1) th) = c_h c_1 - s_h s_1. t_j is the host's float32
// t_points, passed in (the step m/(m-1) is not integral). B lives in the
// scratch. The gradients of the series and the periods are sums over all m
// columns, so B can no longer be stepped slab by slab in the columns phase:
//   3. columns: as above up to gB, then per-block partials of each row's
//      series gradient (gB times 1, cos h th, sin h th) and of its period's
//      term (gB dB/dth th), over the block's columns;
//   4. finalize: the series partials are summed over the blocks (one warp per
//      entry, all blocks); block 0 as above;
//   5. series: every block steps the series and period Adamax from the sums
//      (a few hundred entries, redundantly, into shared memory; block 0 also
//      writes the new state to the scratch), rebuilds its own column slab of
//      B from the new series and forms its partial of the next B Bᵀ;
//   6. gram: the B Bᵀ partials are summed; block 0 stores the new series.
// Seven grid barriers per epoch against the desmo form's five. Rebuilding all
// of B (K m series values) and B Bᵀ (K² m) in every block would save two of
// them but multiply that work by the grid size, so each block rebuilds only
// its own slab and the Gram goes through partials as in the desmo form.
//
// Seed packing (runtime S, 1 <= S <= kMaxSeeds). S models of Ks = T + 3r
// columns each share one read of X: the kernel's K is the packed width
// S * Ks, seed s owning columns [s Ks, (s + 1) Ks) of A and rows of B, latent
// lanes 1 + s r + j of [1 | lat], phi rows s r + j and omega slots
// s 3r + q. A host-built column table (seed, kind, latent lane, omega slot,
// then the P factor lanes of a polynomial column) replaces the single-seed
// rule "columns [0, T) polynomial, [T, K) trig"; at S = 1 it reproduces that
// layout. Only the seeds' diagonal blocks of the Grams exist (S Ks² entries,
// not K²): A gb, ga B, AᵀA and BBᵀ run over the seed's own block, so one
// seed's NaN reaches no other seed (no mask multiplies; off-block entries
// are never formed). rec, the r x r latent Gram, l1 and sum(ax * B) have
// per-seed partials, so total_s = rec_s + beta_s ortho_s + lam_s l1_s. Each
// seed has its scheduler-vector row (its group LRs, best, num_bad, beta,
// lam); the Adamax count, b1^count and the epoch are shared and kept equal
// in every row. Block 0 steps the S scheduler rows.

#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stddef.h>

#include "tile_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRT = 32;   // rows per tile of the rows phase: two m16 tiles of X·Bᵀ
constexpr int kSW = 8;    // columns per sub-slab of the columns phase's B update
constexpr int kMaxK = 128;
constexpr int kStages = 3;  // shared-memory stages in each contraction's cp.async ring

// The kernel is compiled for K padded to KP = 32, 48, 64 or 128, so that the
// tiles and loops over k have fixed sizes.
__host__ __device__ constexpr int padded_k(int K) { return K <= 32 ? 32 : K <= 48 ? 48 : K <= 64 ? 64 : 128; }

// Every form sums in the same order, so that a packed seed's contractions
// equal the one-seed kernel's bit for bit whatever KP is: both contractions
// split their work over the same warps and tiles of rows and columns at
// every KP, and only the number of k tiles differs.
//
// X·Bᵀ (xb_tile): a row tile's kRT rows against B's KP rows, over m in chunks
// of kXbChunk columns; row stride kXbLd (= 4 mod 32: conflict-free fragment
// loads). The warps form kXbGroups groups over the KP / 8 n8 tiles of k;
// the kXbSplit warps of a group split each chunk's k8 steps (warp r of a
// group takes the steps s with s % kXbSplit == r), and each warp's sum over
// a chunk is formed on its own and then added to its running one. The ring
// has xb_stages stages (2 at KP = 128, for shared memory).
constexpr int kXbGroups = 2;
constexpr int kXbSplit = kWarps / kXbGroups;
constexpr int kXbChunk = 64;
constexpr int kXbLd = kXbChunk + 4;
__host__ __device__ constexpr int xb_stages(int KP) { return KP == 128 ? 2 : kStages; }
__host__ __device__ constexpr int xb_ring_floats(int KP) { return xb_stages(KP) * (kRT + KP) * kXbLd; }
// a warp forms at most kMaxTiles of its n8 (X·Bᵀ) or m16 (AᵀX) tiles at once
constexpr int kMaxTiles = 4;

// AᵀX (ax_partial): tiles of kAxRows rows of A, its big and small TF32
// parts (row stride ax_ld_a), and of X (row stride kAxLdX), both = 8 mod 32
// (conflict-free fragment loads). Warp w owns n8 tiles w + kWarps u
// (u < kAxTilesN) of a slab at most kAxMaxWidth wide, and every m16 tile
// of k.
constexpr int kAxRows = 32;
constexpr int kAxLdX = 136;
constexpr int kAxTilesN = 2;
constexpr int kAxMaxWidth = 8 * kWarps * kAxTilesN;
__host__ __device__ constexpr int ax_ld_a(int KP) { return KP + 8; }
__host__ __device__ constexpr int ax_ring_floats(int KP) { return kStages * kAxRows * (2 * ax_ld_a(KP) + kAxLdX); }
static_assert(kAxMaxWidth <= kAxLdX, "a slab fits the X tile");
// the warps' X·Bᵀ sums (kXbSplit of them, kRT x KP each) reuse the ring
static_assert(kXbSplit * kRT * 32 <= xb_ring_floats(32) && kXbSplit * kRT * 48 <= xb_ring_floats(48) &&
              kXbSplit * kRT * 64 <= xb_ring_floats(64) && kXbSplit * kRT * 128 <= xb_ring_floats(128),
              "the warp sums fit the ring");

constexpr int kMaxR = 8;
constexpr int kMaxP = 8;
constexpr int kMaxSeeds = 8;
constexpr int kCT = 4;            // column table: seed, kind (0 polynomial, 1 sin, 2 cos, 3 tanh),
                                  // latent lane, omega slot, then the P factor lanes
constexpr int kMetrics = 5;       // per seed: rec, ortho, l1, total, max |omega * lat|
constexpr int kMaxNf = 63;        // Fourier harmonics
constexpr int kSerTab = 4096;     // shared floats of the columns phase's series table
constexpr float kTwoPi = 6.28318530717958647692f;
// the kernel clock's counters (PhaseClock): the prologue; in the rows phase
// the dictionary, xb, the gradients and Gram partials, and the rest up to
// the end of its barrier; the reduce phase; in the columns phase the phi
// update, block 0's AᵀX partial, the wait at the split's barrier, and the
// rest up to the end of its barrier; the finalize phase; the Fourier form's
// series update and its B Bᵀ reduction
enum Phase {
  kPrologue, kRowsDictionary, kRowsXb, kRowsGradients, kRowsBarrier, kReduce,
  kColumnsPhi, kColumnsAx, kColumnsAxBarrier, kColumnsBarrier, kFinalize, kSeries, kSeriesGram, kPhases
};
constexpr float kB1 = 0.9f, kB2 = 0.999f, kEps = 1e-8f;
constexpr float kOneMinusB1 = (float)(1.0 - 0.9);
constexpr float kImproved = (float)(1.0 - 1e-4);  // plateau threshold, relative
// scheduler-vector slots, one row of kSvec floats per seed
constexpr int kSvec = 16;
constexpr int kLr0 = 0, kBest = 5, kPow = 6, kCount = 7, kNumBad = 8, kEpoch = 9, kBeta = 10, kLam = 11;

struct Args {
  const float* pod;   // (n, r), shared by the seeds
  const float* x;     // (n, m)
  const float* x_sq;  // sum(X * X)
  const int* ctab;    // (K, kCT + P) column table
  float* phi;         // (3, S r, n): phi, mu, nu
  float* b;           // desmo: (3, K, m): B, mu, nu; Fourier: B (K, m) in the scratch
  float* coef;        // (3, K)
  float* omega;       // (3, 3 S r)
  float* svec;        // (S, kSvec) scheduler vectors
  float* met;         // (num_steps, S, kMetrics)
  float* work;        // scratch, make_layout(...).total floats
  int n, m, r, P, K, num_steps, sched_every;  // K = S Ks, the packed width
  float patience, factor, min_lr;
  // the Fourier form's (nf > 0; nf = 0 is the desmo form)
  const float* tpts;  // (m,) t_points
  float* ser;         // (3, K, nc) series coefficients, mu, nu
  float* per;         // (3, K) periods, mu, nu
  int nf;
  int S, Ks;          // seeds, and columns per seed
};

__host__ __device__ inline int round4(int v) { return (v + 3) / 4 * 4; }

// The 2-D split of AᵀX over a grid of G blocks: gr row groups of
// ceil(n / gr) rows x gc column slabs of wc columns (a multiple of 8, at
// most kAxMaxWidth); task (i, j) = block i gc + j, and blocks from gr gc on
// have none (or, where m needs more slabs than G, blocks take tasks b, b + G, ...).
// A is read gc times and the partials are 2 gr K m floats, so gc starts at
// floor(sqrt(2 G m / n)), then widens the slabs to the limit if needed.
struct AxSplit {
  int gr, gc, wc;
};

__host__ __device__ inline AxSplit ax_split(int n, int m, int G) {
  const int wmax = kAxMaxWidth;
  int gc = 1;
  while ((long long)(gc + 1) * (gc + 1) * n <= 2LL * G * m) ++gc;
  const int narrowest = (m + 7) / 8, widest = (m + wmax - 1) / wmax;
  gc = gc < G ? gc : G;
  gc = gc < narrowest ? gc : narrowest;
  gc = gc > widest ? gc : widest;
  AxSplit sp;
  sp.wc = ((m + gc - 1) / gc + 7) / 8 * 8;
  sp.gc = (m + sp.wc - 1) / sp.wc;
  const int groups = G / sp.gc < (n + 7) / 8 ? G / sp.gc : (n + 7) / 8;
  sp.gr = groups > 1 ? groups : 1;
  return sp;
}

// Offsets (in floats) into the scratch buffer for a grid of G blocks; nc is
// the Fourier form's series length 2 nf + 1, 0 for the desmo form.
struct Layout {
  long long a, dl, part, part_max, part_cross, part_gb, sums, gb;
  long long bw, part_ser, sums_ser, ser_next, timer, axp, xp, bp, total;
  int kk;      // entries of the seeds' diagonal Gram blocks, S Ks²
  int lg;      // entries of the seeds' latent Grams, S r²
  int es;      // entries of the summed partials: ga, latᵀlat, gcoef, gomega
  int es_ser;  // Fourier: entries of a series partial, K (nc + 1)
  int lda;     // row stride of A (n, K) in the scratch, round4(K): 16-byte rows, zero from K on
  int mp;      // row stride of the padded copies of X (n, m) and B (K, m) at xp and bp: 32-byte rows, zero from m on
  AxSplit ax;  // the AᵀX split; its partials (gr, K, m) at axp
};

__host__ __device__ inline int padded_m(int m) { return (m + 7) / 8 * 8; }

__host__ __device__ inline Layout make_layout(int n, int m, int r, int Ks, int S, int nc, int G) {
  Layout L;
  const int K = S * Ks, R = S * r;
  L.lda = round4(K);
  L.ax = ax_split(n, m, G);
  L.kk = S * Ks * Ks;
  L.lg = S * r * r;
  L.es = L.kk + L.lg + K + 3 * R;
  L.es_ser = nc > 0 ? K * (nc + 1) : 0;
  const long long fourier = nc > 0;
  long long o = 0;
  L.a = o;          o += (long long)n * L.lda;
  L.dl = o;         o += (long long)n * R;
  L.part = o;       o += (long long)G * L.es;
  L.part_max = o;   o += G;
  L.part_cross = o; o += (long long)G * S;
  L.part_gb = o;    o += (long long)G * L.kk;
  L.sums = o;       o += L.es;
  L.gb = o;         o += 2LL * L.kk;  // by epoch parity
  L.bw = o;         o += fourier * K * m;
  L.part_ser = o;   o += (long long)G * L.es_ser;
  L.sums_ser = o;   o += L.es_ser;
  L.ser_next = o;   o += fourier * 3LL * K * (nc + 1);  // series (3, K, nc), then periods (3, K)
  o += o & 1;
  L.timer = o;      o += 2 * kPhases;  // kPhases unsigned 64-bit ns counters
  L.axp = o;        o += (long long)L.ax.gr * K * m;
  L.mp = padded_m(m);
  o = (o + 7) / 8 * 8;
  L.xp = o;         o += (long long)n * L.mp;
  L.bp = o;         o += (long long)K * L.mp;
  L.total = o;
  return L;
}

// The Layout, kept in shared memory (so that no thread carries its offsets
// in registers through the launch), in floats.
constexpr int kLayoutFloats = (int)((sizeof(Layout) + 15) / 16 * 4);

// Shared memory that lives through the launch: the Layout; the column table
// (K, kCT + P) and, for each latent lane j (of S r), the (column, factor)
// entries of the table that hold lane j + 1 (offsets and entries), for the
// polynomial backward; then the Fourier form's series LRs of the epoch, per
// seed; then the kernel clock's counters.
__host__ __device__ inline int table_floats(int K, int P, int R) {
  return kLayoutFloats + round4(K * (kCT + P)) + round4(R + 1) + round4(K * P) + 2 * kMaxSeeds +
         round4(2 * kPhases);
}

// Shared floats: the tables, then the largest of the phases' own.
__host__ __device__ inline int smem_floats(int r, int Ks, int S, int P, int nc) {
  const int K = S * Ks, R = S * r, ld = K + 1, KP = padded_k(K), kk = S * Ks * Ks;
  const int rows = round4(K) + round4(3 * R) + round4(kk) + kRT * (R + 1) + 4 * kRT * ld +
                   xb_ring_floats(KP) + kThreads + round4(K) + round4(3 * R);
  // the AᵀX ring, then (after the split's barrier, in the same place) the
  // slab's B update
  const int slab = round4(kk) + 3 * K * kSW + kThreads + S * kThreads + (nc > 0 ? kSerTab : 0);
  const int columns = ax_ring_floats(KP) > slab ? ax_ring_floats(KP) : slab;
  const int finalize = kThreads + 4 * kMaxSeeds + kMaxSeeds;
  const int series = nc > 0 ? round4(K * kSW) + round4(K * nc) + round4(K) : 0;
  int most = rows > columns ? rows : columns;
  most = most > finalize ? most : finalize;
  return table_floats(K, P, R) + (most > series ? most : series);
}

#ifndef DESMO_EMULATED_GRID
__device__ __forceinline__ float* shared_base() {
  extern __shared__ float4 desmo_smem4[];
  return reinterpret_cast<float*>(desmo_smem4);
}

__device__ __forceinline__ unsigned long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#endif

// Block 0's thread 0 adds the time since its previous mark to a counter at
// each mark: where the chunk's time goes, at the cost of one clock read per
// mark. Marks inside a phase time block 0's own work; the mark after a grid
// barrier also takes in the wait for the slowest block. The kPhases
// counters live in shared memory (ns), so that no thread carries them in
// registers.
struct PhaseClock {
  unsigned long long* ns;
  unsigned long long last = 0;
  bool on;
  __device__ explicit PhaseClock(unsigned long long* shared) : ns(shared), on(blockIdx.x == 0 && threadIdx.x == 0) {
    if (!on) return;
    for (int p = 0; p < kPhases; ++p) ns[p] = 0;
    last = globaltimer_ns();
  }
  __device__ void mark(int phase) {
    if (!on) return;
    const unsigned long long now = globaltimer_ns();
    ns[phase] += now - last;
    last = now;
  }
  __device__ void store(float* where) const {
    if (!on) return;
    unsigned long long* out = reinterpret_cast<unsigned long long*>(where);
    for (int p = 0; p < kPhases; ++p) out[p] = ns[p];
  }
};

__device__ __forceinline__ float sgn(float v) { return (float)((v > 0.f) - (v < 0.f)); }

// max that propagates NaN from either side, as torch.maximum does
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }

__device__ __forceinline__ void adamax(float* p, float* mu, float* nu, float g, float lr, float bias) {
  const float m1 = kB1 * *mu + kOneMinusB1 * g;
  const float v1 = max_nan(kB2 * *nu, fabsf(g) + kEps);
  *mu = m1;
  *nu = v1;
  *p = *p - (lr / bias) * m1 / v1;
}

// Fixed-order tree reductions over the block; every thread gets the result.
__device__ float block_sum(float v, float* red) {
  const int t = threadIdx.x;
  __syncthreads();
  red[t] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) red[t] += red[t + s];
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

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

constexpr int kGroup = 8;  // entries a thread carries side by side in dA and the Gram partials

// The column table and, for each latent lane j, the entries k * P + p of
// the table whose factor p of column k is lane j + 1 (d_tp[d_off[j]] ..
// d_tp[d_off[j + 1] - 1], in ascending order), in shared memory for the
// whole launch; lr_ep holds the Fourier form's series LRs of the epoch.
struct Tables {
  int* ct;
  int* d_off;
  int* d_tp;
  float* lr_ep;  // lr_z of seed s at [s], lr_period at [kMaxSeeds + s]
  unsigned long long* clock;  // the kernel clock's kPhases counters, 16-byte aligned
};

__device__ Tables build_tables(const Args& a, float* smem) {
  Tables tb;
  const int K = a.K, P = a.P, CT = kCT + P, R = a.S * a.r;
  tb.ct = reinterpret_cast<int*>(smem);
  tb.d_off = tb.ct + round4(K * CT);
  tb.d_tp = tb.d_off + round4(R + 1);
  tb.lr_ep = reinterpret_cast<float*>(tb.d_tp + round4(K * P));
  tb.clock = reinterpret_cast<unsigned long long*>(tb.lr_ep + 2 * kMaxSeeds);
  for (int e = threadIdx.x; e < K * CT; e += kThreads) tb.ct[e] = a.ctab[e];
  __syncthreads();
  // lane j's count, then the offsets in order, then its entries: K P steps
  // for each of the S r lanes, once per launch
  for (int j = threadIdx.x; j < R; j += kThreads) {
    int c = 0;
    for (int e = 0; e < K * P; ++e)
      if (tb.ct[(e / P) * CT + 1] == 0 && tb.ct[(e / P) * CT + kCT + e % P] == j + 1) ++c;
    tb.d_off[j + 1] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    tb.d_off[0] = 0;
    for (int j = 0; j < R; ++j) tb.d_off[j + 1] += tb.d_off[j];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < R; j += kThreads) {
    int o = tb.d_off[j];
    for (int e = 0; e < K * P; ++e)
      if (tb.ct[(e / P) * CT + 1] == 0 && tb.ct[(e / P) * CT + kCT + e % P] == j + 1) tb.d_tp[o++] = e;
  }
  __syncthreads();
  return tb;
}

// dst[i * ld + j] = src[i * cols + j] for j < cols, 0 for cols <= j < ld, over
// every block's threads: a copy of a row-major array with 16-byte aligned
// rows, for the contractions' 16-byte staging.
__device__ void pad_copy(const float* __restrict__ src, int rows, int cols, float* __restrict__ dst, int ld) {
  constexpr int kU = 4;  // loads in flight per thread
  for (int i = blockIdx.x; i < rows; i += gridDim.x) {
    const float* s = src + (long long)i * cols;
    float* d = dst + (long long)i * ld;
    for (int j0 = threadIdx.x; j0 < ld; j0 += kU * kThreads) {
      float v[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) v[u] = j0 + u * kThreads < cols ? s[j0 + u * kThreads] : 0.f;
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (j0 + u * kThreads < ld) d[j0 + u * kThreads] = v[u];
    }
  }
}

// part_gb[e] += sum over the sub-slab's w columns of Bn[k1][jj] * Bn[k2][jj],
// for the entries e = (s Ks + k1') Ks + k2' of the seeds' diagonal blocks
// (k1 = s Ks + k1', k2 = s Ks + k2')
__device__ void accumulate_gb(const float* bn, int w, int Ks, int kk, float* part_gb) {
  for (int e = threadIdx.x; e < kk; e += kThreads) {
    const int s = e / (Ks * Ks), q = e - s * Ks * Ks;
    const int k1 = s * Ks + q / Ks, k2 = s * Ks + q % Ks;
    float g = part_gb[e];
    for (int jj = 0; jj < w; ++jj) g = fmaf(bn[k1 * kSW + jj], bn[k2 * kSW + jj], g);
    part_gb[e] = g;
  }
}

// This block's partial of B Bᵀ over its column slab, from B as it stands.
__device__ void gb_partial(const Args& a, const Layout& L, float* smem) {
  const int K = a.K, m = a.m, G = gridDim.x, b = blockIdx.x;
  float* part_gb = a.work + L.part_gb + (long long)b * L.kk;
  float* bn = smem;
  for (int e = threadIdx.x; e < L.kk; e += kThreads) part_gb[e] = 0.f;
  const int W = (m + G - 1) / G, col_begin = b * W, col_end = min(m, col_begin + W);
  for (int j0 = col_begin; j0 < col_end; j0 += kSW) {
    const int w = min(kSW, col_end - j0);
    __syncthreads();
    for (int e = threadIdx.x; e < K * kSW; e += kThreads) {
      const int k = e / kSW, jj = e % kSW;
      bn[e] = jj < w ? a.b[(long long)k * m + j0 + jj] : 0.f;
    }
    __syncthreads();
    accumulate_gb(bn, w, a.Ks, L.kk, part_gb);
  }
}

// out[e] = the sum over the grid's blocks b of part[b * stride + e], for
// e < count: one warp per entry, lane l adding partials l, l + 32, ... in
// order, then the 32 lane sums added in lane order. Entries from exact_from
// on are summed in double precision, the lane sums in a fixed tree of warp
// shuffles, rounded once to float: the blocks' gcoef and gomega partials
// cancel (at aneurysm's reference init their magnitudes add up to about 130
// times gomega's), so a float32 sum loses about 1e-5 of gomega there. Fixed
// order, so repeatable; every thread of the block must call it.
__device__ void reduce_partials(const float* part, long long stride, int count, float* out, float* red,
                                int exact_from) {
  const int t = threadIdx.x, lane = t % 32, warp = t / 32, G = gridDim.x;
  for (int e0 = blockIdx.x * kWarps; e0 < count; e0 += G * kWarps) {
    const int e = e0 + warp;
    float s = 0.f;
    if (e < count && e >= exact_from) {  // e is the warp's: its lanes agree
      double d = 0.0;
      for (int bb = lane; bb < G; bb += 32) d += part[bb * stride + e];
      for (int o = 16; o > 0; o >>= 1) d += __shfl_down_sync(0xffffffffu, d, o);
      if (lane == 0) out[e] = (float)d;
    } else if (e < count) {
      for (int bb = lane; bb < G; bb += 32) s += part[bb * stride + e];
    }
    __syncthreads();
    red[t] = s;
    __syncthreads();
    if (lane == 0 && e < count && e < exact_from) {
      float v = 0.f;
      for (int l = 0; l < 32; ++l) v += red[t + l];
      out[e] = v;
    }
  }
}

// gb[parity] = B Bᵀ from the blocks' partials.
__device__ void reduce_gb(const Args& a, const Layout& L, int parity, float* red) {
  reduce_partials(a.work + L.part_gb, L.kk, L.kk, a.work + L.gb + (long long)parity * L.kk, red, L.kk);
}

// Fourier: th = 2 pi t_j / period as the host forms it in float32,
// (2 pi t_j) * (1 / period); its cosine and sine.
__device__ __forceinline__ float series_angle(const float* tpts, float inv_period, int j, float* c1, float* s1) {
  const float th = (kTwoPi * tpts[j]) * inv_period;
  sincosf(th, s1, c1);
  return th;
}

// Fourier: the series z (2 nf + 1 coefficients) at the angle whose cosine
// and sine are c1 and s1, the harmonics by the recurrence.
__device__ float series_value(const float* z, int nf, float c1, float s1) {
  float acc = z[0] + z[1] * c1 + z[2] * s1;
  float ck = c1, sk = s1;
  for (int h = 2; h <= nf; ++h) {
    const float ckn = ck * c1 - sk * s1, skn = sk * c1 + ck * s1;
    acc = acc + z[2 * h - 1] * ckn + z[2 * h] * skn;
    ck = ckn;
    sk = skn;
  }
  return acc;
}

// Fourier: this block's column slab of B from the series zc (K, nc) and the
// periods per (K,), written to the scratch's B, then its partial of B Bᵀ.
__device__ void series_slab(const Args& a, const Layout& L, const float* zc, const float* per, float* smem) {
  const int K = a.K, m = a.m, nc = 2 * a.nf + 1, G = gridDim.x;
  const int W = (m + G - 1) / G, col_begin = blockIdx.x * W, w = min(m, col_begin + W) - col_begin;
  for (int e = threadIdx.x; e < K * w; e += kThreads) {
    const int k = e / w, j = col_begin + e % w;
    float c1, s1;
    series_angle(a.tpts, 1.f / per[k], j, &c1, &s1);
    const float v = series_value(zc + k * nc, a.nf, c1, s1);
    a.b[(long long)k * m + j] = v;
    a.work[L.bp + (long long)k * L.mp + j] = v;
  }
  __syncthreads();
  gb_partial(a, L, smem);
}

// Fourier, columns phase: part_ser[k (nc + 1) + c] += the sum over the
// sub-slab's w columns j0.. of gB[k][jj] times dB[k][j] / dz_kc (1, cos h th,
// sin h th) for c < nc, and at c = nc of gB dB/dth th, the period's gradient
// before its factor -1/period. The terms are staged in shared memory (tab,
// kSerTab floats) for a group of rows at a time and summed in column order.
__device__ void series_partial(const Args& a, const float* gb_s, int j0, int w, float* tab, float* part_ser) {
  const int K = a.K, nf = a.nf, nc = 2 * nf + 1, NC = nc + 1;
  const int kg = max(1, kSerTab / (NC * kSW));
  for (int k0 = 0; k0 < K; k0 += kg) {
    const int kn = min(kg, K - k0);
    for (int e = threadIdx.x; e < kn * kSW; e += kThreads) {
      const int kl = e / kSW, jj = e % kSW, k = k0 + kl;
      if (jj >= w) continue;  // never read
      float* col = tab + kl * NC * kSW + jj;
      const float* z = a.ser + (long long)k * nc;
      const float g = gb_s[k * kSW + jj];
      float c1, s1;
      const float th = series_angle(a.tpts, 1.f / a.per[k], j0 + jj, &c1, &s1);
      col[0] = g;
      col[kSW] = g * c1;
      col[2 * kSW] = g * s1;
      float dbdt = z[2] * c1 - z[1] * s1;
      float ck = c1, sk = s1;
      for (int h = 2; h <= nf; ++h) {
        const float ckn = ck * c1 - sk * s1, skn = sk * c1 + ck * s1;
        col[(2 * h - 1) * kSW] = g * ckn;
        col[2 * h * kSW] = g * skn;
        dbdt = dbdt + (float)h * (z[2 * h] * ckn - z[2 * h - 1] * skn);
        ck = ckn;
        sk = skn;
      }
      col[nc * kSW] = g * dbdt * th;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kn * NC; e += kThreads) {
      const float* row = tab + e * kSW;
      float s = part_ser[k0 * NC + e];
      for (int jj = 0; jj < w; ++jj) s += row[jj];
      part_ser[k0 * NC + e] = s;
    }
    __syncthreads();
  }
}

// Fourier, series phase: the series and period Adamax from the reduced
// gradients and the old state, into shared memory in every block (zc_s (K,
// nc), per_s (K)), with each row's seed's LRs of the epoch (lr_ep) and the
// epoch's bias; block 0 also writes the new state with its moments to the
// scratch (ser_next), which the next phase stores.
__device__ void series_update(const Args& a, const Layout& L, const float* lr_ep, float bias, float* zc_s,
                              float* per_s) {
  const int K = a.K, Ks = a.Ks, nc = 2 * a.nf + 1, NC = nc + 1;
  const float* sums = a.work + L.sums_ser;
  float* next = a.work + L.ser_next;
  const long long kn = (long long)K * nc;
  const bool store = blockIdx.x == 0;
  for (int e = threadIdx.x; e < K * nc; e += kThreads) {
    float p = a.ser[e], mu = a.ser[kn + e], nu = a.ser[2 * kn + e];
    adamax(&p, &mu, &nu, sums[(e / nc) * NC + e % nc], lr_ep[(e / nc) / Ks], bias);
    zc_s[e] = p;
    if (store) {
      next[e] = p;
      next[kn + e] = mu;
      next[2 * kn + e] = nu;
    }
  }
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const float g = -(1.f / a.per[k]) * sums[k * NC + nc];
    float p = a.per[k], mu = a.per[K + k], nu = a.per[2 * K + k];
    adamax(&p, &mu, &nu, g, lr_ep[kMaxSeeds + k / Ks], bias);
    per_s[k] = p;
    if (store) {
      next[3 * kn + k] = p;
      next[3 * kn + K + k] = mu;
      next[3 * kn + 2 * K + k] = nu;
    }
  }
  __syncthreads();
}

// Fourier, block 0: the new series and periods from the scratch into the state.
__device__ void store_series(const Args& a, const Layout& L) {
  const long long kn = 3LL * a.K * (2 * a.nf + 1);
  const float* next = a.work + L.ser_next;
  for (long long e = threadIdx.x; e < kn; e += kThreads) a.ser[e] = next[e];
  for (int e = threadIdx.x; e < 3 * a.K; e += kThreads) a.per[e] = next[kn + e];
}

// y[i * ldy + k] = sum_j X[r0 + i][j] B[k][j] for i < kRT, k < K (rows from
// `rows` on are 0): X·Bᵀ for one row tile, in 3xTF32 tiles. X and B come
// from their padded copies (row stride ld, a multiple of 8, zero from m on).
// Chunks of X (kRT x CW) and B (K x CW) pass through a ring of kStages
// stages filled by 16-byte cp.async copies (each thread copies one 16-byte
// piece of a chunk's rows, every RS-th row). Warp w takes the n8
// tiles (k) of group w % NG, at most kMaxTiles at a time, and the k8 steps s
// of each chunk with s % NR == w / NG; its sum over a chunk is formed on its
// own and then added to the running one, and the NR warps' sums are added in
// warp order.
template <int KP>
__device__ void xb_tile(const float* x, const float* bm, int ld, int m, int K, int r0, int rows, float* ring,
                        float* y, int ldy) {
  constexpr int CW = kXbChunk, LD = kXbLd, NG = kXbGroups, NR = kXbSplit, NTW = KP / 8 / NG;
  constexpr int NTH = NTW < kMaxTiles ? NTW : kMaxTiles;  // n8 tiles a pass over the chunk
  constexpr int S = xb_stages(KP), kStage = (kRT + KP) * LD, RS = kThreads / (CW / 4);
  static_assert(kRT % RS == 0, "a chunk of X is copied in whole passes");
  static_assert(CW / 8 % NR == 0, "a chunk's k8 steps split evenly over a group's warps");
  const int t = threadIdx.x, warp = t / 32, ng = warp % NG, kr = warp / NG;
  const int pc = 4 * (t % (CW / 4)), i0 = t / (CW / 4);  // this thread's piece: columns pc.. of rows i0 + RS u
  const int kb = (K + 7) / 8 * 8;  // rows of B staged, zero from K on
  const int nch = (m + CW - 1) / CW;
  const long long step = (long long)RS * ld;
  const float* xp = x + (long long)(r0 + i0) * ld + pc;
  const float* bp = bm + (long long)i0 * ld + pc;
  auto issue = [&](int c) {
    float* xs = ring + (c % S) * kStage + i0 * LD + pc;
    const int j0 = c * CW;
    const bool col = j0 + pc < m;  // the piece lies within the padded row
    const float* src = xp + j0;
#pragma unroll
    for (int u = 0; u < kRT / RS; ++u, src += step) {
      const bool ok = col && i0 + RS * u < rows;
      cp_async16(xs + RS * LD * u, ok ? src : x, ok);
    }
    float* bs = xs + kRT * LD;
    src = bp + j0;
    for (int k = i0; k < kb; k += RS, src += step, bs += RS * LD) {
      const bool ok = col && k < K;
      cp_async16(bs, ok ? src : bm, ok);
    }
  };
  float run[2][NTW][4];
#pragma unroll
  for (int w = 0; w < NTW; ++w)
#pragma unroll
    for (int e = 0; e < 4; ++e) run[0][w][e] = run[1][w][e] = 0.f;
  __syncthreads();  // the ring's previous use is over
  for (int c = 0; c < S - 1; ++c) {
    if (c < nch) issue(c);
    cp_async_commit();
  }
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<S - 2>();
    __syncthreads();  // chunk c is in every thread's view, and chunk c - 1's stage is free
    if (c + S - 1 < nch) issue(c + S - 1);
    cp_async_commit();
    const float* xs = ring + (c % S) * kStage;
    const float* bs = xs + kRT * LD;
#pragma unroll
    for (int h = 0; h < NTW; h += NTH) {
      float acc[2][NTH][4];
#pragma unroll
      for (int w = 0; w < NTH; ++w)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][w][e] = acc[1][w][e] = 0.f;
#pragma unroll
      for (int s = kr; s < CW / 8; s += NR) {  // columns from m on are zero in both
        unsigned a_big[2][4], a_small[2][4];
        load_a_rows(xs + 8 * s, LD, a_big[0], a_small[0]);
        load_a_rows(xs + 16 * LD + 8 * s, LD, a_big[1], a_small[1]);
#pragma unroll
        for (int w = 0; w < NTH; ++w) {
          const int nt = ng * NTW + h + w;
          if (8 * nt < K) {
            unsigned b_big[2], b_small[2];
            load_b_cols(bs + 8 * nt * LD + 8 * s, LD, b_big, b_small);
            mma_3xtf32(acc[0][w], a_big[0], a_small[0], b_big, b_small);
            mma_3xtf32(acc[1][w], a_big[1], a_small[1], b_big, b_small);
          }
        }
      }
#pragma unroll
      for (int w = 0; w < NTH; ++w)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          run[0][h + w][e] += acc[0][w][e];
          run[1][h + w][e] += acc[1][w][e];
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
  float* red = ring;  // (NR, kRT, KP)
#pragma unroll
  for (int w = 0; w < NTW; ++w)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) store_c(run[mt][w], red + (kr * kRT + 16 * mt) * KP + 8 * (ng * NTW + w), KP, 16, 8);
  __syncthreads();
  for (int e = t; e < kRT * K; e += kThreads) {
    const int i = e / K, k = e % K;
    float v = 0.f;
    for (int u = 0; u < NR; ++u) v += red[(u * kRT + i) * KP + k];  // in warp order
    y[i * ldy + k] = v;
  }
}

// out[k * ldo + j] = sum over the rows i in [i0, i1) of A[i][k] X[i][c0 + j],
// for k < K and j < w (w <= kAxMaxWidth): AᵀX over a row group for a
// column slab, in 3xTF32 tiles. A's rows lie at stride lda (a multiple of 4,
// the entries from K on zero), X's (its padded copy) at stride ldx (a
// multiple of 8, zero from m on; c0 a multiple of 8); tiles of kAxRows rows
// pass through a ring of kStages stages filled by 16-byte cp.async copies.
// A piece of X beyond the slab's w columns is copied or zero-filled: only
// outputs j >= w, which are not stored, read it. Every warp reads all of A's
// tile, so each thread splits the pieces of A it copied into their TF32
// parts once, before the tile's barrier (X's fragments, each read by one
// warp, are split as they are loaded).
// Warp w owns the n8 tiles w + kWarps u and every m16 tile of k; each staged
// tile's sum is formed on its own and then added to the running one.
template <int KP>
__device__ void ax_partial(const float* A, int lda, const float* x, int ldx, int K, int i0, int i1, int c0, int w,
                           float* ring, float* out, int ldo) {
  constexpr int MT = KP / 16, NT = kAxTilesN, LDA = ax_ld_a(KP);
  constexpr int MTH = MT < kMaxTiles ? MT : kMaxTiles;  // m16 tiles a pass over the tile
  constexpr int kStage = kAxRows * (2 * LDA + kAxLdX);  // A's big parts, A's small parts, X
  static_assert(kThreads == 256 && kAxRows == 32 && kAxLdX >= 128, "a tile is copied in 4 passes of 8 rows");
  const int t = threadIdx.x, warp = t / 32;
  const int nrows = i1 - i0, ntile = (nrows + kAxRows - 1) / kAxRows, pad = KP - lda;
  // each thread copies the 16-byte pieces at column ca of A's and X's rows
  // ia + 8u (kAxRows rows a tile)
  const int ca = 4 * (t % 32), ia = t / 32;
  const bool a_col = ca < lda, x_col = ca < w;
  const float* ap = A + (long long)(i0 + ia) * lda + ca;
  const float* xp = x + (long long)(i0 + ia) * ldx + c0 + ca;
  __syncthreads();  // the ring's previous use is over
  // A's columns [lda, KP) are never copied: zero in both parts of every stage
  for (int e = t; e < 2 * kStages * kAxRows * pad; e += kThreads) {
    const int part = e / (kAxRows * pad), rc = e % (kAxRows * pad);  // part = 2 stage + (small)
    ring[(part / 2) * kStage + (part % 2) * kAxRows * LDA + (rc / pad) * LDA + lda + rc % pad] = 0.f;
  }
  auto issue = [&](int tile) {
    float* as = ring + (tile % kStages) * kStage + ia * LDA + ca;
    float* xs = ring + (tile % kStages) * kStage + 2 * kAxRows * LDA + ia * kAxLdX + ca;
    const int base = tile * kAxRows;
    const float* src = ap + (long long)base * lda;
#pragma unroll
    for (int u = 0; u < kAxRows / 8; ++u, src += 8 * lda) {
      const bool ok = a_col && base + ia + 8 * u < nrows;
      if (a_col) cp_async16(as + 8 * LDA * u, ok ? src : A, ok);
    }
    src = xp + (long long)base * ldx;
#pragma unroll
    for (int u = 0; u < kAxRows / 8; ++u, src += 8LL * ldx) {
      const bool ok = x_col && base + ia + 8 * u < nrows;
      cp_async16(xs + 8 * kAxLdX * u, ok ? src : x, ok);
    }
  };
  float run[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int u = 0; u < NT; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) run[mt][u][e] = 0.f;
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < ntile) issue(c);
    cp_async_commit();
  }
  for (int tile = 0; tile < ntile; ++tile) {
    cp_async_wait<kStages - 2>();
    if (a_col) {  // this thread's own pieces of A have landed: split them in place
      float* ab = ring + (tile % kStages) * kStage + ia * LDA + ca;
#pragma unroll
      for (int u = 0; u < kAxRows / 8; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          unsigned big, small;
          split_tf32(ab[8 * LDA * u + e], big, small);
          ab[8 * LDA * u + e] = f32_bits(big);
          ab[kAxRows * LDA + 8 * LDA * u + e] = f32_bits(small);
        }
    }
    __syncthreads();  // the tile is in every thread's view, and the previous tile's stage is free
    if (tile + kStages - 1 < ntile) issue(tile + kStages - 1);
    cp_async_commit();
    const float* as = ring + (tile % kStages) * kStage;
    const float* xs = as + 2 * kAxRows * LDA;
#pragma unroll
    for (int h = 0; h < MT; h += MTH) {
      float acc[MTH][NT][4];
#pragma unroll
      for (int mt = 0; mt < MTH; ++mt)
#pragma unroll
        for (int u = 0; u < NT; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][u][e] = 0.f;
#pragma unroll
      for (int s = 0; s < kAxRows / 8; ++s) {  // rows from nrows on are zero
        unsigned b_big[NT][2], b_small[NT][2];
#pragma unroll
        for (int u = 0; u < NT; ++u)
          if (8 * (warp + kWarps * u) < w)
            load_b_rows(xs + 8 * s * kAxLdX + 8 * (warp + kWarps * u), kAxLdX, b_big[u], b_small[u]);
#pragma unroll
        for (int mt = 0; mt < MTH; ++mt) {
          const int gm = h + mt;
          if (16 * gm < K) {
            unsigned a_big[4], a_small[4];
            load_a_cols_split(as + 8 * s * LDA + 16 * gm, as + (kAxRows + 8 * s) * LDA + 16 * gm, LDA, a_big,
                              a_small);
#pragma unroll
            for (int u = 0; u < NT; ++u)
              if (8 * (warp + kWarps * u) < w) mma_3xtf32(acc[mt][u], a_big, a_small, b_big[u], b_small[u]);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MTH; ++mt)
#pragma unroll
        for (int u = 0; u < NT; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) run[h + mt][u][e] += acc[mt][u][e];
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      const int nt = warp + kWarps * u;
      store_c(run[mt][u], out + 16 * mt * ldo + 8 * nt, ldo, K - 16 * mt, w - 8 * nt);
    }
}

// Every block's tasks of the AᵀX split: task (i, j) writes the partial over
// row group i for column slab j into axp[i] (K, m). Blocks without a task
// return at once; the caller's grid barrier orders the partials before
// their sums.
template <int KP>
__device__ void ax_partials(const float* A, int lda, const float* x, int ldx, int n, int m, int K,
                            const AxSplit& sp, float* ring, float* axp) {
  const int rg = (n + sp.gr - 1) / sp.gr;
  for (int task = blockIdx.x; task < sp.gr * sp.gc; task += gridDim.x) {
    const int gi = task / sp.gc, gj = task % sp.gc;
    const int i0 = min(n, gi * rg), i1 = min(n, i0 + rg), c0 = gj * sp.wc;
    ax_partial<KP>(A, lda, x, ldx, K, i0, i1, c0, min(sp.wc, m - c0), ring, axp + (long long)gi * K * m + c0, m);
  }
}

// Phase 1: forward, xb, dA, dl and the per-block partials over the block's rows.
template <int KP>
__device__ void row_phase(const Args& a, const Layout& L, const Tables& tb, float* smem, int step,
                          PhaseClock& clock) {
  const int t = threadIdx.x, b = blockIdx.x, G = gridDim.x;
  const int n = a.n, m = a.m, r = a.r, P = a.P, K = a.K, Ks = a.Ks, ld = K + 1;
  const int R = a.S * r, AW = R + 1, CT = kCT + P, T = Ks - 3 * r;
  const float two_nm = (float)(2.0 / ((double)n * m));
  const int* ct = tb.ct;
  float* p = smem;
  float* c_s = p;   p += round4(K);
  float* om_s = p;  p += round4(3 * R);
  float* gb_s = p;  p += round4(L.kk);
  float* aug_s = p; p += kRT * AW;
  float* D_s = p;   p += kRT * ld;
  float* A_s = p;   p += kRT * ld;
  float* V_s = p;   p += kRT * ld;  // d D / d arg on the trig columns, 0 on the polynomial ones
  float* Y_s = p;   p += kRT * ld;  // xb, then dA
  float* ring = p;  p += xb_ring_floats(KP);
  float* red = p;   p += kThreads;
  float* cacc = p;  p += round4(K);
  float* oacc = p;

  float* part = a.work + L.part + (long long)b * L.es;
  float* part_ga = part;
  float* part_lat = part + L.kk;
  float* A_g = a.work + L.a;
  float* dl_g = a.work + L.dl;
  const float* gb = a.work + L.gb + (long long)(step & 1) * L.kk;

  for (int k = t; k < K; k += kThreads) { c_s[k] = a.coef[k]; cacc[k] = 0.f; }
  for (int q = t; q < 3 * R; q += kThreads) { om_s[q] = a.omega[q]; oacc[q] = 0.f; }
  for (int e = t; e < L.kk; e += kThreads) gb_s[e] = gb[e];
  for (int e = t; e < L.kk + L.lg; e += kThreads) part[e] = 0.f;
  float vmax = 0.f;

  const int Rw = (n + G - 1) / G, row_begin = b * Rw, row_end = min(n, row_begin + Rw);
  for (int r0 = row_begin; r0 < row_end; r0 += kRT) {
    const int rows = min(kRT, row_end - r0);
    __syncthreads();  // the tables are loaded and the previous tile is consumed
    // [1 | lat]: lane 1 + s r + j holds pod[row][j] * phi[s r + j][row]
    for (int e = t; e < kRT * AW; e += kThreads) {
      const int i = e / AW, j = e % AW, row = r0 + i;
      float v = 0.f;
      if (i < rows) v = j == 0 ? 1.f : a.pod[(long long)row * r + (j - 1) % r] * a.phi[(long long)(j - 1) * n + row];
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
    for (int e = t; e < rows * L.lda; e += kThreads) {
      const int i = e / L.lda, k = e % L.lda;
      A_g[(long long)(r0 + i) * L.lda + k] = k < K ? A_s[i * ld + k] : 0.f;
    }
    __syncthreads();
    clock.mark(kRowsDictionary);
    xb_tile<KP>(a.work + L.xp, a.work + L.bp, L.mp, m, K, r0, rows, ring, Y_s, ld);
    __syncthreads();
    clock.mark(kRowsXb);
    // dA = 2/nm (A gb - xb), in place of xb, over each column's seed block
    // of gb; each thread carries kGroup entries side by side
    for (int e0 = 0; e0 < kRT * K; e0 += kGroup * kThreads) {
      int ia[kGroup], ka[kGroup], ga[kGroup];
      float acc[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int e = min(e0 + t + kThreads * u, kRT * K - 1), k = e % K, s = ct[k * CT];
        ia[u] = (e / K) * ld + s * Ks;  // the row's first column of the seed
        ka[u] = k;
        ga[u] = s * Ks * Ks + (k - s * Ks);  // gb block s, column k - s Ks
        acc[u] = 0.f;
      }
      for (int l = 0; l < Ks; ++l)
#pragma unroll
        for (int u = 0; u < kGroup; ++u) acc[u] = fmaf(A_s[ia[u] + l], gb_s[ga[u] + l * Ks], acc[u]);
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int e = e0 + t + kThreads * u;
        if (e < kRT * K) {
          const int o = (e / K) * ld + ka[u];
          Y_s[o] = two_nm * (acc[u] - Y_s[o]);
        }
      }
    }
    __syncthreads();
    // coefficient and omega gradients: warp w takes columns w, w + kWarps,
    // ...; lane i the tile's row i. The 32 rows' terms meet in a fixed
    // pairwise tree of shuffles, neighbouring rows first (lane 0 holds
    // ((t0 + t1) + (t2 + t3)) + ...), and lane 0 adds the tile's sum to the
    // block's, so that no sum runs over more than one tile's rows
    for (int k = t / 32; k < K; k += kWarps) {
      const int* ck = ct + k * CT, i = t % 32;
      const bool trig = ck[1] != 0;
      float gc = 0.f, go = 0.f;
      if (i < rows) {
        const float da = Y_s[i * ld + k];
        gc = da * D_s[i * ld + k];
        if (trig) go = da * c_s[k] * V_s[i * ld + k] * aug_s[i * AW + ck[2]];
      }
      for (int o = 1; o < 32; o <<= 1) {
        gc += __shfl_xor_sync(0xffffffffu, gc, o);
        go += __shfl_xor_sync(0xffffffffu, go, o);
      }
      if (i == 0) {
        cacc[k] += gc;
        if (trig) oacc[ck[3]] += go;
      }
    }
    // dl[row][jl] for latent lane jl = s r + j: the trig part through omega,
    // the polynomial part by the product rule
    for (int e = t; e < rows * R; e += kThreads) {
      const int i = e / R, jl = e % R, s = jl / r, j = jl % r;
      const float* ag = aug_s + i * AW;
      float trig = 0.f;
      for (int kind = 0; kind < 3; ++kind) {
        const int q = s * 3 * r + kind * r + j, k = s * Ks + T + kind * r + j;
        trig += Y_s[i * ld + k] * c_s[k] * V_s[i * ld + k] * om_s[q];
      }
      float poly = 0.f;
      for (int d = tb.d_off[jl]; d < tb.d_off[jl + 1]; ++d) {
        const int tt = tb.d_tp[d] / P, q = tb.d_tp[d] % P;
        float prod = Y_s[i * ld + tt] * c_s[tt];
        for (int u = 0; u < P; ++u)
          if (u != q) prod *= ag[ct[tt * CT + kCT + u]];
        poly += prod;
      }
      dl_g[(long long)(r0 + i) * R + jl] = trig + poly;
    }
    // Gram partials over the tile's rows: the seeds' diagonal blocks of AᵀA,
    // kGroup entries side by side, and their latent Grams latᵀlat
    for (int e0 = 0; e0 < L.kk; e0 += kGroup * kThreads) {
      int k1[kGroup], k2[kGroup];
      float g[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int e = min(e0 + t + kThreads * u, L.kk - 1), s = e / (Ks * Ks), q = e - s * Ks * Ks;
        k1[u] = s * Ks + q / Ks;
        k2[u] = s * Ks + q % Ks;
        g[u] = part_ga[e];
      }
      for (int i = 0; i < rows; ++i)
#pragma unroll
        for (int u = 0; u < kGroup; ++u) g[u] = fmaf(A_s[i * ld + k1[u]], A_s[i * ld + k2[u]], g[u]);
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
        if (e0 + t + kThreads * u < L.kk) part_ga[e0 + t + kThreads * u] = g[u];
    }
    for (int e = t; e < L.lg; e += kThreads) {
      const int s = e / (r * r), j1 = (e / r) % r, j2 = e % r;
      float g = part_lat[e];
      for (int i = 0; i < rows; ++i) g = fmaf(aug_s[i * AW + 1 + s * r + j1], aug_s[i * AW + 1 + s * r + j2], g);
      part_lat[e] = g;
    }
    __syncthreads();
    clock.mark(kRowsGradients);
  }
  for (int k = t; k < K; k += kThreads) part[L.kk + L.lg + k] = cacc[k];
  for (int q = t; q < 3 * R; q += kThreads) part[L.kk + L.lg + K + q] = oacc[q];
  vmax = block_max(vmax, red);
  if (t == 0) a.work[L.part_max + b] = vmax;
}

// Phase 2: sums = the row phase's partials summed over the blocks, gcoef
// and gomega in double precision.
__device__ void reduce_phase(const Args& a, const Layout& L, float* red) {
  reduce_partials(a.work + L.part, L.es, L.es, a.work + L.sums, red, L.kk + L.lg);
}

// Phase 3: phi Adamax of the block's rows; the AᵀX split's partials and a
// grid barrier; ax (the partials summed) and gB over the block's column
// slab, then the B Adamax and the next B Bᵀ partial (desmo) or the series
// gradient partials (Fourier).
template <int KP, bool kFourier>
__device__ void column_phase(const Args& a, const Layout& L, float* smem, PhaseClock& clock) {
  const int t = threadIdx.x, b = blockIdx.x, G = gridDim.x;
  const int n = a.n, m = a.m, r = a.r, K = a.K, Ks = a.Ks, S = a.S, R = S * r;
  const float two_nm = (float)(2.0 / ((double)n * m));
  const float bias = 1.f - a.svec[kPow] * kB1;
  const float* sums = a.work + L.sums;
  const float* latg = sums + L.kk;
  const float* dl_g = a.work + L.dl;
  const float* A_g = a.work + L.a;

  // phi: one thread per row, each seed in turn; lat is read in full before
  // the seed's update of the row
  const int Rw = (n + G - 1) / G, row_begin = b * Rw, row_end = min(n, row_begin + Rw);
  for (int row = row_begin + t; row < row_end; row += kThreads) {
    float lat[kMaxR], pd[kMaxR];
    for (int j = 0; j < r; ++j) pd[j] = a.pod[(long long)row * r + j];
    for (int s = 0; s < S; ++s) {
      const float lr_phi = a.svec[s * kSvec + kLr0 + 1], beta = a.svec[s * kSvec + kBeta];
      const float* lg = latg + s * r * r;
      for (int j = 0; j < r; ++j) lat[j] = pd[j] * a.phi[(long long)(s * r + j) * n + row];
      for (int j = 0; j < r; ++j) {
        float dlo = 0.f;
        for (int l = 0; l < r; ++l)
          if (l != j) dlo = fmaf(lat[l], sgn(lg[l * r + j]), dlo);
        const float g = (dl_g[(long long)row * R + s * r + j] + beta * dlo) * pd[j];
        const long long o = (long long)(s * r + j) * n + row, rn = (long long)R * n;
        adamax(a.phi + o, a.phi + rn + o, a.phi + 2 * rn + o, g, lr_phi, bias);
      }
    }
  }
  __syncthreads();
  clock.mark(kColumnsPhi);

  const float* axp = a.work + L.axp;
  ax_partials<KP>(A_g, L.lda, a.work + L.xp, L.mp, n, m, K, L.ax, smem, a.work + L.axp);
  clock.mark(kColumnsAx);
  cg::this_grid().sync();
  clock.mark(kColumnsAxBarrier);

  float* ga_s = smem;  // in place of the ring
  float* p = smem + round4(L.kk);
  float* Bo = p;   p += K * kSW;
  float* Bn = p;   p += K * kSW;
  float* ax_s = p; p += K * kSW;
  float* red = p;  p += kThreads;
  float* crs = p;  p += S * kThreads;    // each thread's sum(ax * B) by seed
  float* tab = p;  // Fourier: kSerTab floats
  for (int e = t; e < L.kk; e += kThreads) ga_s[e] = sums[e];
  for (int s = 0; s < S; ++s) crs[s * kThreads + t] = 0.f;
  float* part_gb = a.work + L.part_gb + (long long)b * L.kk;
  float* part_ser = a.work + L.part_ser + (long long)b * L.es_ser;
  if (kFourier) {
    for (int e = t; e < L.es_ser; e += kThreads) part_ser[e] = 0.f;
  } else {
    for (int e = t; e < L.kk; e += kThreads) part_gb[e] = 0.f;
  }
  const long long km = (long long)K * m;
  const int W = (m + G - 1) / G, col_begin = b * W, col_end = min(m, col_begin + W);
  for (int j0 = col_begin; j0 < col_end; j0 += kSW) {
    const int w = min(kSW, col_end - j0);
    __syncthreads();  // the previous sub-slab is consumed
    // ax: the split's partials summed in row-group order, four loads at a time
    for (int o = t; o < K * kSW; o += kThreads) {
      const int k = o / kSW, jj = o % kSW;
      float v = 0.f, bo = 0.f;
      if (jj < w) {
        const float* src = axp + (long long)k * m + j0 + jj;
        int gi = 0;
        for (; gi + 4 <= L.ax.gr; gi += 4, src += 4 * km) {
          const float p0 = src[0], p1 = src[km], p2 = src[2 * km], p3 = src[3 * km];
          v = v + p0 + p1 + p2 + p3;
        }
        for (; gi < L.ax.gr; ++gi, src += km) v += *src;
        bo = a.b[(long long)k * m + j0 + jj];
      }
      ax_s[o] = v;
      Bo[o] = bo;
    }
    __syncthreads();
    // sum(ax * B) by seed, gB = 2/nm (ga B - ax) over the row's seed block
    // of ga, and the B Adamax (desmo; Bn the new B) or gB alone (Fourier;
    // Bn holds gB); seed s owns the entries [s Ks kSW, (s + 1) Ks kSW)
    for (int s = 0; s < S; ++s) {
      const float lr_z = a.svec[s * kSvec + kLr0 + 2];
      const float* gas = ga_s + s * Ks * Ks;
      const float* bos = Bo + s * Ks * kSW;
      float cross = crs[s * kThreads + t];
      for (int o = s * Ks * kSW + t; o < (s + 1) * Ks * kSW; o += kThreads) {
        const int k = o / kSW, jj = o % kSW, kl = k - s * Ks;
        float nb = 0.f;
        if (jj < w) {
          cross = fmaf(ax_s[o], Bo[o], cross);
          float sm = 0.f;
          for (int l = 0; l < Ks; ++l) sm = fmaf(gas[kl * Ks + l], bos[l * kSW + jj], sm);
          const float g = two_nm * (sm - ax_s[o]);
          if (kFourier) {
            nb = g;
          } else {
            const long long gi = (long long)k * m + j0 + jj;
            adamax(a.b + gi, a.b + km + gi, a.b + 2 * km + gi, g, lr_z, bias);
            nb = a.b[gi];
            a.work[L.bp + (long long)k * L.mp + j0 + jj] = nb;
          }
        }
        Bn[o] = nb;
      }
      crs[s * kThreads + t] = cross;
    }
    __syncthreads();
    if (kFourier)
      series_partial(a, Bn, j0, w, tab, part_ser);
    else
      accumulate_gb(Bn, w, Ks, L.kk, part_gb);
  }
  for (int s = 0; s < S; ++s) {
    const float cross = block_sum(crs[s * kThreads + t], red);
    if (t == 0) a.work[L.part_cross + (long long)b * S + s] = cross;
  }
}

// Block 0: out[4 s + w] for seed s = sum(ga * gb) over its block (w = 0),
// sum(ax * B) over the grid's partials (1), the sum of |latᵀlat| off the
// diagonal (2) and sum |c| over its columns (3). One warp per entry, lanes
// strided over its terms, the 32 lane sums added in lane order.
__device__ void seed_sums(const Args& a, const Layout& L, const float* ga, const float* gb, const float* latg,
                          float* out, float* red) {
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int S = a.S, Ks = a.Ks, r = a.r, G = gridDim.x, kb = Ks * Ks;
  for (int i0 = 0; i0 < 4 * S; i0 += kWarps) {
    const int it = i0 + warp, s = it / 4, w = it % 4;
    float v = 0.f;
    if (it < 4 * S) {
      if (w == 0) {
        for (int e = lane; e < kb; e += 32) v = fmaf(ga[s * kb + e], gb[s * kb + e], v);
      } else if (w == 1) {
        for (int bb = lane; bb < G; bb += 32) v += a.work[L.part_cross + (long long)bb * S + s];
      } else if (w == 2) {
        for (int e = lane; e < r * r; e += 32)
          if (e / r != e % r) v += fabsf(latg[s * r * r + e]);
      } else {
        for (int k = lane; k < Ks; k += 32) v += fabsf(a.coef[s * Ks + k]);
      }
    }
    __syncthreads();
    red[t] = v;
    __syncthreads();
    if (lane == 0 && it < 4 * S) {
      float u = 0.f;
      for (int l = 0; l < 32; ++l) u += red[t + l];
      out[it] = u;
    }
  }
  __syncthreads();
}

// Phase 4, block 0: the metrics rows, the coefficient and omega Adamax and
// the plateau schedulers, each seed with its own LRs, beta and lambda.
__device__ void finalize(const Args& a, const Layout& L, const Tables& tb, float* smem, int step) {
  const int t = threadIdx.x, G = gridDim.x;
  const int r = a.r, K = a.K, S = a.S, R = S * r, CT = kCT + a.P;
  float* red = smem;
  float* ss = smem + kThreads;         // seed_sums' out
  float* tot = ss + 4 * kMaxSeeds;     // total of each seed
  const float* sums = a.work + L.sums;
  const float* ga = sums;
  const float* latg = ga + L.kk;
  const float* gcoef = latg + L.lg;
  const float* gom = gcoef + K;
  const float* gb = a.work + L.gb + (long long)(step & 1) * L.kk;
  float* sv = a.svec;
  const float powb = sv[kPow] * kB1;
  const float bias = 1.f - powb;

  float v = 0.f;
  for (int bb = t; bb < G; bb += kThreads) v = max_nan(v, a.work[L.part_max + bb]);
  const float maxarg = block_max(v, red);
  seed_sums(a, L, ga, gb, latg, ss, red);  // its barriers order the reads of c before the updates
  const float nm = (float)((double)a.n * a.m);
  if (t < S) {
    const int s = t;
    const float rec = (ss[4 * s] - 2.f * ss[4 * s + 1] + *a.x_sq) / nm;
    const float ortho = 0.5f * ss[4 * s + 2], l1 = ss[4 * s + 3];
    const float total = rec + sv[s * kSvec + kBeta] * ortho + sv[s * kSvec + kLam] * l1;
    tot[s] = total;
    float* row = a.met + ((long long)step * S + s) * kMetrics;
    row[0] = rec;
    row[1] = ortho;
    row[2] = l1;
    row[3] = total;
    row[4] = maxarg;
  }
  for (int k = t; k < K; k += kThreads) {
    const float* svs = sv + tb.ct[k * CT] * kSvec;
    const float g = gcoef[k] + svs[kLam] * sgn(a.coef[k]);
    adamax(a.coef + k, a.coef + K + k, a.coef + 2 * K + k, g, svs[kLr0], bias);
  }
  for (int q = t; q < 3 * R; q += kThreads)
    adamax(a.omega + q, a.omega + 3 * R + q, a.omega + 6 * R + q, gom[q], sv[(q / (3 * r)) * kSvec + kLr0 + 3], bias);
  __syncthreads();  // every thread has read the scheduler vectors, and tot is written
  if (t < S) {
    float* svs = sv + t * kSvec;
    const float total = tot[t];
    const float best = svs[kBest], num_bad = svs[kNumBad], epoch = svs[kEpoch];
    const bool improved = total < best * kImproved;
    const float best_n = improved ? total : best;
    float nb = improved ? 0.f : num_bad + 1.f;
    const bool reduce = nb > a.patience;
    if (reduce) nb = 0.f;
    if (fmodf(epoch, (float)a.sched_every) == 0.f) {
      for (int g = 0; g < 5; ++g) {
        const float lr = svs[kLr0 + g];
        svs[kLr0 + g] = reduce ? fmaxf(lr * a.factor, a.min_lr) : lr;
      }
      svs[kBest] = best_n;
      svs[kNumBad] = nb;
    }
    svs[kPow] = powb;
    svs[kCount] = svs[kCount] + 1.f;
    svs[kEpoch] = epoch + 1.f;
  }
}

template <int KP, bool kFourier>
__global__ void __launch_bounds__(kThreads, 1) train_chunk_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  const int nc = kFourier ? 2 * a.nf + 1 : 0;
  Layout* shared_layout = reinterpret_cast<Layout*>(shared_base());
  if (threadIdx.x == 0) *shared_layout = make_layout(a.n, a.m, a.r, a.Ks, a.S, nc, gridDim.x);
  __syncthreads();
  const Layout& L = *shared_layout;
  if (kFourier) a.b = a.work + L.bw;
  const Tables tb = build_tables(a, shared_base() + kLayoutFloats);
  PhaseClock clock(tb.clock);
  float* smem = shared_base() + table_floats(a.K, a.P, a.S * a.r);  // each phase's own shared memory
  float* zc_s = smem + round4(a.K * kSW);           // Fourier, series phase
  float* per_s = zc_s + round4(a.K * nc);
  // the padded copies of X and B that the contractions stage (the Fourier
  // form's B comes from series_slab, which writes both; here its pad)
  pad_copy(a.x, a.n, a.m, a.work + L.xp, L.mp);
  if (kFourier) {
    for (int k = blockIdx.x; k < a.K; k += gridDim.x)
      for (int j = a.m + threadIdx.x; j < L.mp; j += kThreads) a.work[L.bp + (long long)k * L.mp + j] = 0.f;
    series_slab(a, L, a.ser, a.per, smem);
  } else {
    pad_copy(a.b, a.K, a.m, a.work + L.bp, L.mp);
    gb_partial(a, L, smem);
  }
  grid.sync();
  reduce_gb(a, L, 0, smem);
  grid.sync();
  clock.mark(kPrologue);
  for (int step = 0; step < a.num_steps; ++step) {
    // read before block 0's finalize of this epoch steps the schedulers
    float bias = 0.f;
    if (kFourier) {
      bias = 1.f - a.svec[kPow] * kB1;
      for (int s = threadIdx.x; s < a.S; s += kThreads) {
        tb.lr_ep[s] = a.svec[s * kSvec + kLr0 + 2];
        tb.lr_ep[kMaxSeeds + s] = a.svec[s * kSvec + kLr0 + 4];
      }
    }
    row_phase<KP>(a, L, tb, smem, step, clock);
    grid.sync();
    clock.mark(kRowsBarrier);
    reduce_phase(a, L, smem);
    grid.sync();
    clock.mark(kReduce);
    column_phase<KP, kFourier>(a, L, smem, clock);
    grid.sync();
    clock.mark(kColumnsBarrier);
    if constexpr (kFourier) {
      reduce_partials(a.work + L.part_ser, L.es_ser, L.es_ser, a.work + L.sums_ser, smem, L.es_ser);
      if (blockIdx.x == 0) finalize(a, L, tb, smem, step);
      grid.sync();
      clock.mark(kFinalize);
      series_update(a, L, tb.lr_ep, bias, zc_s, per_s);
      series_slab(a, L, zc_s, per_s, smem);
      grid.sync();
      clock.mark(kSeries);
      reduce_gb(a, L, (step + 1) & 1, smem);
      if (blockIdx.x == 0) store_series(a, L);
      grid.sync();
      clock.mark(kSeriesGram);
    } else {
      reduce_gb(a, L, (step + 1) & 1, smem);
      if (blockIdx.x == 0) finalize(a, L, tb, smem, step);
      grid.sync();
      clock.mark(kFinalize);
    }
  }
  clock.store(a.work + L.timer);
}

// The contractions alone, for tests: xb = X Bᵀ (n, K) and ax = Aᵀ X (K, m)
// from A (n, K), B (K, m) and X (n, m), through the kernel's own routines
// (xb_tile over each block's rows as in the rows phase; the AᵀX split as in
// the columns phase). Scratch: A at stride round4(K), the split's partials,
// then the padded copies of X and B.
struct ProbeArgs {
  const float* a;
  const float* b;
  const float* x;
  float* xb;
  float* ax;
  float* work;
  int n, m, K;
};

__host__ __device__ inline long long probe_padded_offset(int n, int m, int K, int G) {
  return ((long long)n * round4(K) + (long long)ax_split(n, m, G).gr * K * m + 7) / 8 * 8;
}

__host__ __device__ inline long long probe_workspace(int n, int m, int K, int G) {
  return probe_padded_offset(n, m, K, G) + (long long)(n + K) * padded_m(m);
}

__host__ __device__ inline int probe_smem_floats(int K) {
  const int KP = padded_k(K), rows = kRT * (K + 1) + xb_ring_floats(KP);
  return rows > ax_ring_floats(KP) ? rows : ax_ring_floats(KP);
}

template <int KP>
__global__ void __launch_bounds__(kThreads, 1) contract_probe_kernel(ProbeArgs p) {
  cg::grid_group grid = cg::this_grid();
  const int t = threadIdx.x, b = blockIdx.x, G = gridDim.x, n = p.n, m = p.m, K = p.K, lda = round4(K);
  const AxSplit sp = ax_split(n, m, G);
  const int mp = padded_m(m);
  float* A_g = p.work;
  float* axp = p.work + (long long)n * lda;
  float* xp = p.work + probe_padded_offset(n, m, K, G);
  float* bp = xp + (long long)n * mp;
  float* smem = shared_base();
  const long long stride = (long long)G * kThreads, first = (long long)b * kThreads + t;
  pad_copy(p.a, n, K, A_g, lda);
  pad_copy(p.x, n, m, xp, mp);
  pad_copy(p.b, K, m, bp, mp);
  grid.sync();
  float* y = smem;
  const int Rw = (n + G - 1) / G, row_begin = b * Rw, row_end = min(n, row_begin + Rw);
  for (int r0 = row_begin; r0 < row_end; r0 += kRT) {
    const int rows = min(kRT, row_end - r0);
    xb_tile<KP>(xp, bp, mp, m, K, r0, rows, smem + kRT * (K + 1), y, K + 1);
    __syncthreads();
    for (int e = t; e < rows * K; e += kThreads) p.xb[(long long)(r0 + e / K) * K + e % K] = y[(e / K) * (K + 1) + e % K];
  }
  grid.sync();
  ax_partials<KP>(A_g, lda, xp, mp, n, m, K, sp, smem, axp);
  grid.sync();
  for (long long e = first; e < (long long)K * m; e += stride) {
    float v = 0.f;
    for (int gi = 0; gi < sp.gr; ++gi) v += axp[(long long)gi * K * m + e];  // in row-group order
    p.ax[e] = v;
  }
}

using ProbeFn = void (*)(ProbeArgs);

ProbeFn probe_for(int K) {
  switch (padded_k(K)) {
    case 32: return contract_probe_kernel<32>;
    case 48: return contract_probe_kernel<48>;
    case 64: return contract_probe_kernel<64>;
    default: return contract_probe_kernel<128>;
  }
}

size_t smem_bytes(int r, int Ks, int S, int P, int nc) {
  return sizeof(float) * (size_t)smem_floats(r, Ks, S, P, nc);
}

using KernelFn = void (*)(Args);

template <bool kFourier>
KernelFn kernel_for_k(int K) {
  switch (padded_k(K)) {
    case 32: return train_chunk_kernel<32, kFourier>;
    case 48: return train_chunk_kernel<48, kFourier>;
    case 64: return train_chunk_kernel<64, kFourier>;
    default: return train_chunk_kernel<128, kFourier>;
  }
}

KernelFn kernel_for(int K, int nf) { return nf > 0 ? kernel_for_k<true>(K) : kernel_for_k<false>(K); }

bool valid_shape(int r, int P, int Ks, int S, int nf) {
  return r >= 1 && r <= kMaxR && P >= 1 && P <= kMaxP && S >= 1 && S <= kMaxSeeds && Ks > 3 * r &&
         S * Ks <= kMaxK && nf >= 0 && nf <= kMaxNf;
}

}  // namespace

extern "C" {

// Blocks of the cooperative launch on the current device (one per SM), or a
// negative cudaError_t: cooperative launch unsupported, or no block fits.
// Ks = T + 3r columns per seed, S seeds; nf is the number of Fourier
// harmonics, 0 for the desmo form.
int desmo_chunk_grid(int r, int P, int Ks, int S, int nf) {
  if (!valid_shape(r, P, Ks, S, nf)) return -(int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return -(int)err;
  if (!coop) return -(int)cudaErrorNotSupported;
  const size_t bytes = smem_bytes(r, Ks, S, P, nf > 0 ? 2 * nf + 1 : 0);
  const void* kernel = (const void*)kernel_for(S * Ks, nf);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes);
  if (err != cudaSuccess) return -(int)err;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  return sms;
}

// Floats of scratch the launch needs for a grid of `grid` blocks.
long long desmo_chunk_workspace(int n, int m, int r, int Ks, int S, int nf, int grid) {
  return make_layout(n, m, r, Ks, S, nf > 0 ? 2 * nf + 1 : 0, grid).total;
}

// Offset (in floats) in the scratch of the launch's kPhases 64-bit
// nanosecond counters (enum Phase), summed over the epochs.
long long desmo_chunk_timer_offset(int n, int m, int r, int Ks, int S, int nf, int grid) {
  return make_layout(n, m, r, Ks, S, nf > 0 ? 2 * nf + 1 : 0, grid).timer;
}

// Offset (in floats) in the scratch of the last epoch's summed partials:
// each seed's diagonal Gram block (S Ks²), latent Gram (S r²), then gcoef
// (S Ks) and gomega (3 S r).
long long desmo_chunk_sums_offset(int n, int m, int r, int Ks, int S, int nf, int grid) {
  return make_layout(n, m, r, Ks, S, nf > 0 ? 2 * nf + 1 : 0, grid).sums;
}

// Runs num_steps epochs of S packed seeds in place on phi, coef, omega,
// svec and either b (desmo, nf = 0; tpts, ser and per unused) or ser and per
// (Fourier, nf > 0; b unused); writes the metrics rows. ctab is the (S Ks,
// kCT + P) column table. Returns a cudaError_t.
int desmo_train_chunk(const float* pod, const float* x, const float* x_sq, const int* ctab,
                      const float* tpts, float* phi, float* b, float* ser, float* per,
                      float* coef, float* omega, float* svec, float* met, float* work,
                      int n, int m, int r, int P, int Ks, int S, int nf, int num_steps,
                      int sched_every, int grid, float patience, float factor, float min_lr,
                      void* stream) {
  if (!valid_shape(r, P, Ks, S, nf) || n < 1 || m < 1 || num_steps < 1 || sched_every < 1 || grid < 1 ||
      !ctab || (nf > 0 ? (!tpts || !ser || !per) : !b))
    return (int)cudaErrorInvalidValue;
  const int K = S * Ks;
  Args args{pod, x, x_sq, ctab, phi, b, coef, omega, svec, met, work,
            n, m, r, P, K, num_steps, sched_every, patience, factor, min_lr,
            tpts, ser, per, nf, S, Ks};
  const size_t bytes = smem_bytes(r, Ks, S, P, nf > 0 ? 2 * nf + 1 : 0);
  const void* kernel = (const void*)kernel_for(K, nf);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads),
                                    params, bytes, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Floats of scratch desmo_chunk_contract_probe needs for a grid of `grid` blocks.
long long desmo_chunk_probe_workspace(int n, int m, int K, int grid) { return probe_workspace(n, m, K, grid); }

// Test entry, off the training path: xb = X Bᵀ (n, K) and ax = Aᵀ X (K, m)
// from row-major A (n, K), B (K, m) and X (n, m) through the kernel's own
// contraction routines, in one cooperative launch of `grid` blocks (at most
// desmo_chunk_grid's). Returns a cudaError_t.
int desmo_chunk_contract_probe(const float* a, const float* b, const float* x, float* xb, float* ax, float* work,
                               int n, int m, int K, int grid, void* stream) {
  if (n < 1 || m < 1 || K < 1 || K > kMaxK || grid < 1) return (int)cudaErrorInvalidValue;
  ProbeArgs args{a, b, x, xb, ax, work, n, m, K};
  const size_t bytes = sizeof(float) * (size_t)probe_smem_floats(K);
  const void* kernel = (const void*)probe_for(K);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), params, bytes, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
