// One optimizer step of DESMO over one rank's rows, in one cooperative
// launch: the replicated update of the previous step from its all-reduced
// sums (a prologue), then this step's forward and gradient partials over the
// rank's rows. Between two launches the ranks all-reduce the partial sums
// with one SUM (desmo_tpu_torch/kernels/shard_step.py, which holds the plain
// version of this kernel beside its wrapper).
//
// Replaces the TPU kernel desmo_tpu/pallas/shard_step.py:74 _make_step_kernel
// and the replicated update that the reference runs as fused XLA operations
// between its launches (shard_step.py:318-409), desmo and Fourier forms, for
// one seed or S seed-packed models (_build_step_call(n_seeds=S) :168, reached
// from make_sharded_fused_ensemble_chunk :478, whose per-seed reductions and
// updates run at :616-743). With nm = n_total * m the global count and s the
// launch's step counter (a device integer: the launches with rows so far in
// the chunk, so that a CUDA graph of one step can replay it):
//   prologue, when s > 0, from the summed partials of step s - 1: the
//     metrics row s - 1 (rec, ortho, l1, total) of the pre-update
//     parameters; gB = 2/nm (ga B - ax); the Adamax of c (with lam sign(c)),
//     omega and B, or in the Fourier form of the series and the periods
//     through the series backward; the plateau scheduler; this rank's phi
//     Adamax with the ortho term beta lat (sign(latᵀlat) ∘ offdiag), from
//     step s - 1's per-row latent gradient dl. Then (when rows) B, or the
//     Fourier series' B, padded for the rows phase, and gb = B Bᵀ;
//   rows (unless the launch's rows flag is 0, which ends a chunk):
//     lat = pod * phiᵀ, the library D and A = D * c, xb = X Bᵀ,
//     dA = 2/nm (A gb - xb), dl without the ortho term (its sign needs the
//     summed latent Gram, so the next launch adds it), and the partial sums
//     ax = AᵀX (K, m), ga = AᵀA (K, K), latᵀlat (r, r), the coefficient
//     gradient sum(dA * D) (K) and the omega gradient (3r), into `sums`,
//     which the ranks then all-reduce; max |omega * lat| into max_arg[s]
//     (telemetry: the wrapper all-reduces that row with MAX once a chunk).
// Everything that crosses launches is an argument (the state, sums, dl, gb
// = B Bᵀ of the B the last partials used, the metrics and max_arg rows, the
// counter); the scratch lives for one launch, but its clock counters add up
// across launches.
//
// Bound on an H100 SXM at the cylinder shape on one rank (n=3961, m=1001,
// r=4, P=3: K=47): the work of one mega-kernel epoch, about 0.78 GFLOP (AᵀX
// and X Bᵀ 2nmK each, A gb 2nK², ga B 2K²m, the symmetric AᵀA nK(K+1) and
// B Bᵀ mK(K+1)): 11.6 us at the 67 TFLOP/s fp32 rate; with the two
// contractions as three TF32 passes on the tensor cores at 495 TFLOP/s and
// the rest at the fp32 rate, 5.0 us. A launch reads X (15.9 MB) and moves
// the state, the sums and dl, about 18 MB: 5.4 us at 3.35 TB/s, so under
// 3xTF32 a launch is bound by its bytes (the mega-kernel keeps X in L2 from
// one epoch to the next).
//
// Seed packing (runtime S, 1 <= S <= kMaxSeeds), as the mega-kernel packs:
// K is the packed width S Ks, seed s owning columns [s Ks, (s + 1) Ks) of A
// and rows of B, latent lanes 1 + s r + j, phi rows s r + j, omega slots
// s 3r + q and row s of the scheduler vectors; the host's column table says
// which. Only the seeds' diagonal blocks of gb = B Bᵀ and ga = AᵀA exist (S
// Ks² entries), so A gb, ga B and rec run over the seed's own block and one
// seed's NaN reaches no other seed. The latent Gram, rec, l1 and sum(ax * B)
// are per seed; each seed has its LRs, beta, lambda, plateau scheduler and
// metrics row. S = 1 is one model.
//
// Design. One persistent cooperative launch of one block per SM, the
// single-device mega-kernel's phases (csrc/train_chunk.cu), each routine a
// copy of its counterpart there (marked "as train_chunk.cu <name>"),
// rearranged so that the update comes first:
//   P1 (when s > 0) phi of the block's rows; each block's column slab: ax
//      and the old B, the partial of sum(ax * B), gB, the B Adamax (desmo)
//      or the series gradient partials (Fourier); then (when rows) the
//      slab of the new B into its padded copy and its B Bᵀ partial;
//   P2 the B Bᵀ partials summed into gb, and block 0's finalize (metrics,
//      c and omega Adamax, scheduler); the Fourier form first sums its
//      series partials, steps the series in every block (P3) and sums the
//      B Bᵀ partials after that (P4);
//   R1 rows: each block owns a contiguous row range, in tiles of kRT rows:
//      the dictionary, X Bᵀ (xb_tile: 3xTF32 mma.sync tiles staged by
//      cp.async from the padded copies of X and B), dA, dl, the per-block
//      partials;
//   R2 the partials summed over the blocks, one warp per entry; AᵀX through
//      the 2-D split (ax_partials: g_r row groups x g_c column slabs, the
//      same tiles);
//   R3 the owners of each column sum the split's g_r partials in row-group
//      order into ax.
// Grid barriers between the phases: four a launch in the desmo form, six in
// the Fourier form. Every sum across threads or blocks runs in a fixed order,
// so two launches give identical bits, and the replicated state, computed
// from the same summed partials on every rank, is the same bits there. The
// LRs and the Adamax bias are read at the launch's start, before block 0's
// scheduler step (as the mega-kernel reads its series LRs). A per-phase
// clock (PhaseClock) says where the time goes. The TPU's bf16 hi/lo passes,
// 128-lane packing, selection matmuls and fast sin/cos do not carry over:
// trig is CUDA's full-range sincosf/tanhf, and the polynomial backward is the
// product rule over the P factors, so it needs no guard where lat == 0. The
// kernel allocates nothing and does not synchronise; the entry point returns
// the launch's cudaError_t.

#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stddef.h>

#include "tile_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRT = 32;   // rows per tile of the rows phase: two m16 tiles of X·Bᵀ
constexpr int kSW = 8;    // columns per sub-slab of the prologue's column slab
constexpr int kMaxK = 128;
constexpr int kStages = 3;  // shared-memory stages in each contraction's cp.async ring

// The kernel is compiled for K padded to KP = 32, 48, 64 or 128, so that the
// tiles and loops over k have fixed sizes.
__host__ __device__ constexpr int padded_k(int K) { return K <= 32 ? 32 : K <= 48 ? 48 : K <= 64 ? 64 : 128; }

// X·Bᵀ and AᵀX tiles: as train_chunk.cu kXbGroups, kXbSplit, kXbChunk, kXbLd,
// xb_stages, xb_ring_floats, kMaxTiles, kAxRows, kAxLdX, kAxTilesN,
// kAxMaxWidth, ax_ld_a and ax_ring_floats, for the copies of its xb_tile and
// ax_partial below.
constexpr int kXbGroups = 2;
constexpr int kXbSplit = kWarps / kXbGroups;
constexpr int kXbChunk = 64;
constexpr int kXbLd = kXbChunk + 4;
__host__ __device__ constexpr int xb_stages(int KP) { return KP == 128 ? 2 : kStages; }
__host__ __device__ constexpr int xb_ring_floats(int KP) { return xb_stages(KP) * (kRT + KP) * kXbLd; }
constexpr int kMaxTiles = 4;
constexpr int kAxRows = 32;
constexpr int kAxLdX = 136;
constexpr int kAxTilesN = 2;
constexpr int kAxMaxWidth = 8 * kWarps * kAxTilesN;
__host__ __device__ constexpr int ax_ld_a(int KP) { return KP + 8; }
__host__ __device__ constexpr int ax_ring_floats(int KP) { return kStages * kAxRows * (2 * ax_ld_a(KP) + kAxLdX); }
static_assert(kAxMaxWidth <= kAxLdX, "a slab fits the X tile");
static_assert(kXbSplit * kRT * 32 <= xb_ring_floats(32) && kXbSplit * kRT * 48 <= xb_ring_floats(48) &&
              kXbSplit * kRT * 64 <= xb_ring_floats(64) && kXbSplit * kRT * 128 <= xb_ring_floats(128),
              "the warp sums fit the ring");

constexpr int kMaxR = 8;
constexpr int kMaxP = 8;
constexpr int kMaxSeeds = 8;     // as train_chunk.cu kMaxSeeds: the packed seeds' cap
constexpr int kCT = 4;            // column table: seed, kind (0 polynomial, 1 sin, 2 cos, 3 tanh),
                                  // latent lane, omega slot, then the P factor lanes
constexpr int kMetrics = 4;       // per seed: rec, ortho, l1, total
constexpr int kMaxNf = 63;        // Fourier harmonics
constexpr int kSerTab = 4096;     // shared floats of the series gradient's table
constexpr float kTwoPi = 6.28318530717958647692f;
// the kernel clock's counters (PhaseClock): from the launch's start, the
// Layout and the tables; the prologue's update (P1, and the Fourier form's
// P2-P3) and its B Bᵀ reduction with block 0's finalize;
// in the rows phase the dictionary, xb, the gradients and Gram partials, and
// the rest up to the end of its barrier; the reduction of the partials;
// block 0's AᵀX partial, the wait at the split's barrier and the owners'
// sums of AᵀX
enum Phase {
  kSetup, kUpdate, kGram, kRowsDictionary, kRowsXb, kRowsGradients, kRowsBarrier, kReduce, kAx, kAxBarrier, kAxSum, kPhases
};
constexpr float kB1 = 0.9f, kB2 = 0.999f, kEps = 1e-8f;
constexpr float kOneMinusB1 = (float)(1.0 - 0.9);
constexpr float kImproved = (float)(1.0 - 1e-4);  // plateau threshold, relative
// scheduler-vector slots, one row of kSvec floats per seed
constexpr int kSvec = 16;
constexpr int kLr0 = 0, kBest = 5, kPow = 6, kCount = 7, kNumBad = 8, kEpoch = 9, kBeta = 10, kLam = 11;
// the launch's hyperparameters (Tables::hyp), kMaxSeeds entries each, seed s
// at [h * kMaxSeeds + s]; lr_z and lr_period first, where series_update reads
// them (train_chunk.cu's lr_ep)
enum Hyp { kHypLrZ, kHypLrPeriod, kHypLrCoef, kHypLrPhi, kHypLrOmega, kHypBias, kHypBeta, kHypLam, kHyps };

struct Args {
  const float* pod;   // (n, r): this rank's rows, shared by the seeds
  const float* xp;    // (n, mp): this rank's rows of X, padded to mp = padded_m(m) with zeros
  const float* x_sq;  // sum(X * X) over every rank's rows
  const int* ctab;    // the column table (K, kCT + P), then the lane lists: d_off (S r + 1), d_tp (K P)
  float* phi;         // (3, S r, n): phi, mu, nu of this rank's rows
  float* b;           // desmo: (3, K, m) B, mu, nu; unused in the Fourier form
  float* coef;        // (3, K)
  float* omega;       // (3, 3 S r)
  float* svec;        // (S, kSvec) scheduler vectors
  float* sums;        // ax (K m), the seeds' blocks of ga (S Ks²), their latᵀlat (S r²), gcoef (K), gomega (3 S r)
  float* dl;          // (n, S r)
  float* gb;          // (S Ks²) the seeds' diagonal blocks of B Bᵀ of the B the last partials used
  float* met;         // (num_steps, S, kMetrics)
  float* max_arg;     // (num_steps)
  int* count;         // the step counter s
  float* work;        // scratch, make_layout(...).total floats
  int n, m, r, P, K, n_total, rows, sched_every, num_steps;  // K = S Ks; rows s of met and max_arg exist for s < num_steps
  float patience, factor, min_lr;
  // the Fourier form's (nf > 0; nf = 0 is the desmo form)
  const float* tpts;  // (m,) t_points
  float* ser;         // (3, K, nc) series coefficients, mu, nu
  float* per;         // (3, K) periods, mu, nu
  int nf;
  int S, Ks;          // seeds, and columns per seed
};

__host__ __device__ inline int round4(int v) { return (v + 3) / 4 * 4; }
__host__ __device__ inline int padded_m(int m) { return (m + 7) / 8 * 8; }

// The seed count and a seed's width: the packed forms (kPacked) read them
// from the launch, the one-seed forms know them (S = 1, Ks = K), so that
// their loops over the seeds and the seeds' offsets fold away.
template <bool kPacked>
__device__ __forceinline__ int seed_count(const Args& a) { return kPacked ? a.S : 1; }
template <bool kPacked>
__device__ __forceinline__ int seed_width(const Args& a) { return kPacked ? a.Ks : a.K; }

// as train_chunk.cu AxSplit, ax_split: the 2-D split of AᵀX over G blocks
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

// Offsets (in floats) into the scratch for a grid of G blocks; nc is the
// Fourier form's series length 2 nf + 1, 0 for the desmo form.
struct Layout {
  long long a, part, part_max, part_cross, part_gb, part_ser, sums_ser, ser_next, gagb, timer, axp, bp, total;
  int kk;      // entries of the seeds' diagonal Gram blocks, S Ks²
  int lg;      // entries of the seeds' latent Grams, S r²
  int es;      // entries of a block's partial: ga, latᵀlat, gcoef, gomega
  int es_ser;  // Fourier: entries of a series partial, K (nc + 1)
  int lda;     // row stride of A (n, K) in the scratch, round4(K): 16-byte rows, zero from K on
  int mp;      // row stride of the padded copies of X and B: 32-byte rows, zero from m on
  AxSplit ax;  // the AᵀX split; its partials (gr, K, m) at axp
};

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
  L.part = o;       o += (long long)G * L.es;
  L.part_max = o;   o += G;
  L.part_cross = o; o += (long long)G * S;
  L.part_gb = o;    o += (long long)G * L.kk;
  L.part_ser = o;   o += (long long)G * L.es_ser;
  L.sums_ser = o;   o += L.es_ser;
  L.ser_next = o;   o += fourier * 3LL * K * (nc + 1);  // series (3, K, nc), then periods (3, K)
  L.gagb = o;       o += S;  // each seed's sum(ga * gb)
  o += o & 1;
  L.timer = o;      o += 2 * kPhases;  // kPhases unsigned 64-bit ns counters, summed over launches
  L.axp = o;        o += (long long)L.ax.gr * K * m;
  L.mp = padded_m(m);
  o = (o + 7) / 8 * 8;
  L.bp = o;         o += (long long)K * L.mp;
  L.total = o;
  return L;
}

// The Layout, kept in shared memory (so that no thread carries its offsets
// in registers through the launch), in floats.
constexpr int kLayoutFloats = (int)((sizeof(Layout) + 15) / 16 * 4);

// Shared memory that lives through the launch: the Layout; the kernel
// clock's counters; the column table and, for each latent lane j (of S r),
// the entries of the table that hold lane j + 1 (offsets and entries), for
// the polynomial backward; the launch's hyperparameters (enum Hyp).
constexpr int kClockFloats = (2 * kPhases + 3) / 4 * 4;
__host__ __device__ inline int table_floats(int K, int P, int R) {
  return kLayoutFloats + kClockFloats + round4(K * (kCT + P)) + round4(R + 1) + round4(K * P) + kHyps * kMaxSeeds;
}

// Shared floats: the tables, then the largest of the phases' own.
__host__ __device__ inline int smem_floats(int r, int Ks, int S, int P, int nc) {
  const int K = S * Ks, R = S * r, ld = K + 1, KP = padded_k(K), kk = S * Ks * Ks;
  const int rows = round4(K) + round4(3 * R) + round4(kk) + kRT * (R + 1) + 4 * kRT * ld + xb_ring_floats(KP) +
                   kThreads + round4(K) + round4(3 * R);
  const int slab = 2 * round4(kk) + 3 * K * kSW + kThreads + S * kThreads + (nc > 0 ? kSerTab : 0);
  const int series = round4(K * nc) + round4(K) + K * kSW;
  const int finalize = kThreads + 4 * kMaxSeeds + kMaxSeeds;
  int most = rows > ax_ring_floats(KP) ? rows : ax_ring_floats(KP);
  most = most > slab ? most : slab;
  most = most > series ? most : series;
  most = most > finalize ? most : finalize;
  return table_floats(K, P, R) + most;
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

// as train_chunk.cu PhaseClock; store adds the launch's counters to those in
// the scratch, so a run of launches sums them
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
    for (int p = 0; p < kPhases; ++p) out[p] += ns[p];
  }
};

__device__ __forceinline__ float sgn(float v) { return (float)((v > 0.f) - (v < 0.f)); }

// max that propagates NaN from either side, as torch.maximum does
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }

// as train_chunk.cu adamax
__device__ __forceinline__ void adamax(float* p, float* mu, float* nu, float g, float lr, float bias) {
  const float m1 = kB1 * *mu + kOneMinusB1 * g;
  const float v1 = max_nan(kB2 * *nu, fabsf(g) + kEps);
  *mu = m1;
  *nu = v1;
  *p = *p - (lr / bias) * m1 / v1;
}

// as train_chunk.cu block_sum, block_max: fixed-order tree reductions over
// the block; every thread gets the result
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
// d_tp[d_off[j + 1] - 1], in ascending order), as train_chunk.cu Tables
// holds them; hyp holds each seed's LRs, bias, beta and lambda (enum Hyp),
// read before block 0's scheduler step. The host builds the lane lists
// (kernels/shard_step.py kernel_table: they depend on the shape alone), so
// a launch only copies them in; train_chunk.cu build_tables forms them once
// a chunk, which would take a fifth of a launch at cylinder here.
struct Tables {
  int* ct;
  int* d_off;
  int* d_tp;
  float* hyp;  // kHyps x kMaxSeeds
};

template <bool kPacked>
__device__ Tables build_tables(const Args& a, float* smem) {
  Tables tb;
  const int K = a.K, P = a.P, CT = kCT + P, R = seed_count<kPacked>(a) * a.r;
  tb.ct = reinterpret_cast<int*>(smem);
  tb.d_off = tb.ct + round4(K * CT);
  tb.d_tp = tb.d_off + round4(R + 1);
  tb.hyp = reinterpret_cast<float*>(tb.d_tp + round4(K * P));
  const int* lanes = a.ctab + K * CT;
  for (int e = threadIdx.x; e < K * CT; e += kThreads) tb.ct[e] = a.ctab[e];
  for (int e = threadIdx.x; e < R + 1; e += kThreads) tb.d_off[e] = lanes[e];
  for (int e = threadIdx.x; e < K * P; e += kThreads) tb.d_tp[e] = lanes[R + 1 + e];
  for (int e = threadIdx.x; e < kHyps * seed_count<kPacked>(a); e += kThreads) {
    const int s = e / kHyps, h = e % kHyps;
    const int slot = h == kHypLrZ ? kLr0 + 2 : h == kHypLrPeriod ? kLr0 + 4 : h == kHypLrCoef ? kLr0
                   : h == kHypLrPhi ? kLr0 + 1 : h == kHypLrOmega ? kLr0 + 3 : h == kHypBias ? kPow
                   : h == kHypBeta ? kBeta : kLam;
    const float v = a.svec[s * kSvec + slot];
    tb.hyp[h * kMaxSeeds + s] = h == kHypBias ? 1.f - v * kB1 : v;
  }
  __syncthreads();
  return tb;
}

// as train_chunk.cu accumulate_gb, seed by seed (one division an entry):
// part_gb[s Ks² + e] += the sum over the sub-slab's w columns of
// Bn[k1][jj] * Bn[k2][jj] for seed s's diagonal block, k1 = s Ks + e / Ks,
// k2 = s Ks + e % Ks
__device__ void accumulate_gb(const float* bn, int w, int Ks, int S, float* part_gb) {
  const int kb = Ks * Ks;
  for (int s = 0; s < S; ++s)
    for (int e = threadIdx.x; e < kb; e += kThreads) {
      const int k1 = s * Ks + e / Ks, k2 = s * Ks + e % Ks;
      float g = part_gb[s * kb + e];
      for (int jj = 0; jj < w; ++jj) g = fmaf(bn[k1 * kSW + jj], bn[k2 * kSW + jj], g);
      part_gb[s * kb + e] = g;
    }
}

// as train_chunk.cu reduce_partials: out[e] = the sum over the grid's blocks
// b of part[b * stride + e], for e < count: one warp per entry, lane l adding
// partials l, l + 32, ... in order, then the 32 lane sums in lane order;
// entries from exact_from on (gcoef and gomega) in double precision, the
// lane sums in a fixed tree of warp shuffles; every thread of the block must
// call it.
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

// as train_chunk.cu series_angle, series_value: th = 2 pi t_j / period as the
// host forms it, (2 pi t_j) * (1 / period), with its cosine and sine; the
// series z (2 nf + 1 coefficients) at that angle, harmonics by recurrence
__device__ __forceinline__ float series_angle(const float* tpts, float inv_period, int j, float* c1, float* s1) {
  const float th = (kTwoPi * tpts[j]) * inv_period;
  sincosf(th, s1, c1);
  return th;
}

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

// as train_chunk.cu series_partial: part_ser[k (nc + 1) + c] += the sum over
// the sub-slab's w columns j0.. of gB[k][jj] times dB[k][j] / dz_kc (1,
// cos h th, sin h th) for c < nc, and at c = nc of gB dB/dth th, the
// period's gradient before its factor -1/period, in column order
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

// as train_chunk.cu series_update: the series and period Adamax from the
// reduced gradients and the old state, into shared memory in every block
// (zc_s (K, nc), per_s (K)), with each row's seed's LRs of the launch (lr_ep:
// the hyperparameters' lr_z and lr_period rows) and the launch's bias; block
// 0 also writes the new state with its moments to the scratch (ser_next),
// which store_series stores after the next grid barrier
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

// as train_chunk.cu store_series: block 0, the new series and periods from
// the scratch into the state
__device__ void store_series(const Args& a, const Layout& L) {
  const long long kn = 3LL * a.K * (2 * a.nf + 1);
  const float* next = a.work + L.ser_next;
  for (long long e = threadIdx.x; e < kn; e += kThreads) a.ser[e] = next[e];
  for (int e = threadIdx.x; e < 3 * a.K; e += kThreads) a.per[e] = next[kn + e];
}

// The block's column slab of B: columns [b W, (b + 1) W) with W = ceil(m / G).
__device__ __forceinline__ void column_slab(int m, int* begin, int* end) {
  const int W = (m + gridDim.x - 1) / gridDim.x;
  *begin = blockIdx.x * W;
  *end = min(m, *begin + W);
}

// Zero the padded copy of B from column m on (its rows k = b, b + G, ...).
__device__ void zero_b_pad(const Args& a, const Layout& L) {
  for (int k = blockIdx.x; k < a.K; k += gridDim.x)
    for (int j = a.m + threadIdx.x; j < L.mp; j += kThreads) a.work[L.bp + (long long)k * L.mp + j] = 0.f;
}

// The new B's sub-slab bn (K x kSW, w columns) into the padded copy, and its
// B Bᵀ partial.
template <bool kPacked>
__device__ void store_b_slab(const Args& a, const Layout& L, const float* bn, int j0, int w, float* part_gb) {
  for (int o = threadIdx.x; o < a.K * kSW; o += kThreads) {
    const int k = o / kSW, jj = o % kSW;
    if (jj < w) a.work[L.bp + (long long)k * L.mp + j0 + jj] = bn[o];
  }
  accumulate_gb(bn, w, seed_width<kPacked>(a), seed_count<kPacked>(a), part_gb);
}

// P1, the block's rows of phi (when update): one thread per row, each seed in
// turn, as train_chunk.cu column_phase's phi step, with step s - 1's dl, the
// summed latent Grams' signs and the launch's LRs and betas.
template <bool kPacked>
__device__ void phi_update(const Args& a, const float* hyp) {
  const int n = a.n, r = a.r, S = seed_count<kPacked>(a), R = S * r, G = gridDim.x, Ks = seed_width<kPacked>(a);
  const float* latg = a.sums + (long long)a.K * a.m + (long long)S * Ks * Ks;
  const float bias = hyp[kHypBias * kMaxSeeds];
  const int Rw = (n + G - 1) / G, row_begin = blockIdx.x * Rw, row_end = min(n, row_begin + Rw);
  const long long rn = (long long)R * n;
  for (int row = row_begin + threadIdx.x; row < row_end; row += kThreads) {
    float lat[kMaxR], pd[kMaxR];
    for (int j = 0; j < r; ++j) pd[j] = a.pod[(long long)row * r + j];
    for (int s = 0; s < S; ++s) {
      const float lr_phi = hyp[kHypLrPhi * kMaxSeeds + s], beta = hyp[kHypBeta * kMaxSeeds + s];
      const float* lg = latg + s * r * r;
      for (int j = 0; j < r; ++j) lat[j] = pd[j] * a.phi[(long long)(s * r + j) * n + row];
      for (int j = 0; j < r; ++j) {
        float dlo = 0.f;
        for (int l = 0; l < r; ++l)
          if (l != j) dlo = fmaf(lat[l], sgn(lg[l * r + j]), dlo);
        const float g = (a.dl[(long long)row * R + s * r + j] + beta * dlo) * pd[j];
        const long long o = (long long)(s * r + j) * n + row;
        adamax(a.phi + o, a.phi + rn + o, a.phi + 2 * rn + o, g, lr_phi, bias);
      }
    }
  }
}

// P1, the block's column slab, in sub-slabs of kSW columns: the old B (desmo:
// the state's; Fourier: from the old series) and, when update, the summed ax,
// this block's partials of each seed's sum(ax * B), gB = 2/nm (ga B - ax)
// over the row's seed block of ga and the B Adamax with the seed's lr_z
// (desmo; as train_chunk.cu column_phase's slab) or the series gradient
// partials (Fourier); block 0 also forms each seed's sum(ga * gb) of the old
// gb for the metrics. Then, when rows and B is final here (desmo, or the
// Fourier form without an update), the slab of B into its padded copy and
// its B Bᵀ partial.
template <bool kFourier, bool kPacked>
__device__ void slab_phase(const Args& a, const Layout& L, const float* hyp, float* smem, bool update) {
  const int t = threadIdx.x, b = blockIdx.x;
  const int m = a.m, K = a.K, Ks = seed_width<kPacked>(a), S = seed_count<kPacked>(a);
  const float two_nm = (float)(2.0 / ((double)a.n_total * m));
  const float bias = hyp[kHypBias * kMaxSeeds];
  float* ga_s = smem;
  float* p = smem + round4(L.kk);
  float* Bo = p;   p += K * kSW;
  float* Bn = p;   p += K * kSW;
  float* ax_s = p; p += K * kSW;
  float* red = p;  p += kThreads;
  float* crs = p;  p += S * kThreads;  // each thread's sum(ax * B) by seed
  float* tab = p;  // Fourier: kSerTab floats
  float* gb_s = tab + (kFourier ? kSerTab : 0);  // block 0: the old gb
  const bool gram = a.rows && !(kFourier && update);
  float* part_gb = a.work + L.part_gb + (long long)b * L.kk;
  float* part_ser = a.work + L.part_ser + (long long)b * L.es_ser;
  const long long km = (long long)K * m;
  if (update) {
    for (int e = t; e < L.kk; e += kThreads) ga_s[e] = a.sums[km + e];
    for (int s = 0; s < S; ++s) crs[s * kThreads + t] = 0.f;
    if (kFourier)
      for (int e = t; e < L.es_ser; e += kThreads) part_ser[e] = 0.f;
    if (b == 0) {  // each seed's sum(ga * gb) of the old gb, before P2 writes the new: warp s's 32 lanes, added in
                   // lane order, the old gb staged in shared memory first
      for (int e = t; e < L.kk; e += kThreads) gb_s[e] = a.gb[e];
      __syncthreads();
      const int lane = t % 32, warp = t / 32, kb = Ks * Ks;
      float v = 0.f;
      if (warp < S)
        for (int e = lane; e < kb; e += 32) v = fmaf(ga_s[warp * kb + e], gb_s[warp * kb + e], v);
      red[t] = v;
      __syncthreads();
      if (lane == 0 && warp < S) {
        float u = 0.f;
        for (int l = 0; l < 32; ++l) u += red[t + l];
        a.work[L.gagb + warp] = u;
      }
    }
  }
  if (gram) {
    for (int e = t; e < L.kk; e += kThreads) part_gb[e] = 0.f;
    zero_b_pad(a, L);
  }
  int col_begin, col_end;
  column_slab(m, &col_begin, &col_end);
  const int nc = 2 * a.nf + 1;
  for (int j0 = col_begin; j0 < col_end; j0 += kSW) {
    const int w = min(kSW, col_end - j0);
    __syncthreads();  // the previous sub-slab is consumed
    for (int o = t; o < K * kSW; o += kThreads) {
      const int k = o / kSW, jj = o % kSW;
      float v = 0.f, bo = 0.f;
      if (jj < w) {
        if (kFourier) {
          float c1, s1;
          series_angle(a.tpts, 1.f / a.per[k], j0 + jj, &c1, &s1);
          bo = series_value(a.ser + (long long)k * nc, a.nf, c1, s1);
        } else {
          bo = a.b[(long long)k * m + j0 + jj];
        }
        if (update) v = a.sums[(long long)k * m + j0 + jj];
      }
      ax_s[o] = v;
      Bo[o] = bo;
    }
    __syncthreads();
    if (update) {
      // seed s owns the entries [s Ks kSW, (s + 1) Ks kSW)
      for (int s = 0; s < S; ++s) {
        const float lr_z = hyp[kHypLrZ * kMaxSeeds + s];
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
            }
          }
          Bn[o] = nb;
        }
        crs[s * kThreads + t] = cross;
      }
      __syncthreads();
      if (kFourier) series_partial(a, Bn, j0, w, tab, part_ser);
    }
    if (gram) store_b_slab<kPacked>(a, L, update ? Bn : Bo, j0, w, part_gb);
  }
  if (update)
    for (int s = 0; s < S; ++s) {
      const float cross = block_sum(crs[s * kThreads + t], red);
      if (t == 0) a.work[L.part_cross + (long long)b * S + s] = cross;
    }
}

// P2, block 0: as train_chunk.cu seed_sums, with each seed's sum(ga * gb)
// from P1: out[4 s + w] for seed s = sum(ga * gb) over its block (w = 0),
// sum(ax * B) over the grid's partials (1), the sum of |latᵀlat| off the
// diagonal (2) and sum |c| over its columns (3). One warp per entry, lanes
// strided over its terms, the 32 lane sums added in lane order.
template <bool kPacked>
__device__ void seed_sums(const Args& a, const Layout& L, const float* latg, float* out, float* red) {
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int S = seed_count<kPacked>(a), Ks = seed_width<kPacked>(a), r = a.r, G = gridDim.x;
  for (int i0 = 0; i0 < 4 * S; i0 += kWarps) {
    const int it = i0 + warp, s = it / 4, w = it % 4;
    float v = 0.f;
    if (it < 4 * S) {
      if (w == 0) {
        v = lane == 0 ? a.work[L.gagb + s] : 0.f;
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

// P2, block 0: as train_chunk.cu finalize, for the update of step s - 1: the
// metrics rows s - 1 of the pre-update parameters, the coefficient and omega
// Adamax and the plateau schedulers, each seed with its own LRs, beta and
// lambda.
template <bool kPacked>
__device__ void finalize(const Args& a, const Layout& L, const Tables& tb, float* smem, int s) {
  const int t = threadIdx.x;
  const int r = a.r, K = a.K, S = seed_count<kPacked>(a), R = S * r, CT = kCT + a.P;
  float* red = smem;
  float* ss = smem + kThreads;         // seed_sums' out
  float* tot = ss + 4 * kMaxSeeds;     // total of each seed
  const float* ga = a.sums + (long long)K * a.m;
  const float* latg = ga + L.kk;
  const float* gcoef = latg + L.lg;
  const float* gom = gcoef + K;
  float* sv = a.svec;
  const float powb = sv[kPow] * kB1;
  const float bias = 1.f - powb;
  seed_sums<kPacked>(a, L, latg, ss, red);  // its barriers order the reads of c before the updates
  if (t < S) {
    const float nm = (float)((double)a.n_total * a.m);
    const float rec = (ss[4 * t] - 2.f * ss[4 * t + 1] + *a.x_sq) / nm;
    const float ortho = 0.5f * ss[4 * t + 2], l1 = ss[4 * t + 3];
    const float total = rec + tb.hyp[kHypBeta * kMaxSeeds + t] * ortho + tb.hyp[kHypLam * kMaxSeeds + t] * l1;
    tot[t] = total;
    if (s - 1 < a.num_steps) {
      float* row = a.met + ((long long)(s - 1) * S + t) * kMetrics;
      row[0] = rec;
      row[1] = ortho;
      row[2] = l1;
      row[3] = total;
    }
  }
  for (int k = t; k < K; k += kThreads) {  // each column's seed's lambda and LR, the launch's (tb.hyp)
    const int seed = tb.ct[k * CT];
    const float g = gcoef[k] + tb.hyp[kHypLam * kMaxSeeds + seed] * sgn(a.coef[k]);
    adamax(a.coef + k, a.coef + K + k, a.coef + 2 * K + k, g, tb.hyp[kHypLrCoef * kMaxSeeds + seed], bias);
  }
  for (int q = t; q < 3 * R; q += kThreads)
    adamax(a.omega + q, a.omega + 3 * R + q, a.omega + 6 * R + q, gom[q], tb.hyp[kHypLrOmega * kMaxSeeds + q / (3 * r)],
           bias);
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

// P3 (Fourier, when rows): as train_chunk.cu series_slab, the block's column
// slab of the new B from the new series zc_s (K, nc) and periods per_s (K),
// in sub-slabs, into the padded copy, and its B Bᵀ partial.
template <bool kPacked>
__device__ void series_slab(const Args& a, const Layout& L, const float* zc_s, const float* per_s, float* bn) {
  const int K = a.K, nc = 2 * a.nf + 1;
  float* part_gb = a.work + L.part_gb + (long long)blockIdx.x * L.kk;
  for (int e = threadIdx.x; e < L.kk; e += kThreads) part_gb[e] = 0.f;
  zero_b_pad(a, L);
  int col_begin, col_end;
  column_slab(a.m, &col_begin, &col_end);
  for (int j0 = col_begin; j0 < col_end; j0 += kSW) {
    const int w = min(kSW, col_end - j0);
    __syncthreads();
    for (int o = threadIdx.x; o < K * kSW; o += kThreads) {
      const int k = o / kSW, jj = o % kSW;
      float v = 0.f;
      if (jj < w) {
        float c1, s1;
        series_angle(a.tpts, 1.f / per_s[k], j0 + jj, &c1, &s1);
        v = series_value(zc_s + k * nc, a.nf, c1, s1);
      }
      bn[o] = v;
    }
    __syncthreads();
    store_b_slab<kPacked>(a, L, bn, j0, w, part_gb);
  }
}

// as train_chunk.cu xb_tile: y[i * ldy + k] = sum_j X[r0 + i][j] B[k][j] for
// i < kRT, k < K (rows from `rows` on are 0), in 3xTF32 tiles from the padded
// copies of X and B (row stride ld), chunks staged through a cp.async ring;
// the warps' sums added in warp order.
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

// as train_chunk.cu ax_partial: out[k * ldo + j] = sum over the rows i in
// [i0, i1) of A[i][k] X[i][c0 + j], for k < K and j < w, in 3xTF32 tiles of
// kAxRows rows staged through a cp.async ring; A's pieces split into their
// TF32 parts once by the thread that copied them; each staged tile's sum
// formed on its own and then added to the running one.
template <int KP>
__device__ void ax_partial(const float* A, int lda, const float* x, int ldx, int K, int i0, int i1, int c0, int w,
                           float* ring, float* out, int ldo) {
  constexpr int MT = KP / 16, NT = kAxTilesN, LDA = ax_ld_a(KP);
  constexpr int MTH = MT < kMaxTiles ? MT : kMaxTiles;  // m16 tiles a pass over the tile
  constexpr int kStage = kAxRows * (2 * LDA + kAxLdX);  // A's big parts, A's small parts, X
  static_assert(kThreads == 256 && kAxRows == 32 && kAxLdX >= 128, "a tile is copied in 4 passes of 8 rows");
  const int t = threadIdx.x, warp = t / 32;
  const int nrows = i1 - i0, ntile = (nrows + kAxRows - 1) / kAxRows, pad = KP - lda;
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

// as train_chunk.cu ax_partials: every block's tasks of the AᵀX split, task
// (i, j) writing the partial over row group i for column slab j into axp[i]
// (K, m); blocks without a task return at once.
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

// R1, as train_chunk.cu row_phase: forward, xb, dA, dl and the per-block
// partials over the block's rows, with the step's gb, dl and 2/nm.
template <int KP, bool kPacked>
__device__ void row_phase(const Args& a, const Layout& L, const Tables& tb, float* smem, PhaseClock& clock) {
  const int t = threadIdx.x, b = blockIdx.x, G = gridDim.x;
  const int n = a.n, m = a.m, r = a.r, P = a.P, K = a.K, Ks = seed_width<kPacked>(a), ld = K + 1;
  const int R = seed_count<kPacked>(a) * r, AW = R + 1, CT = kCT + P, T = Ks - 3 * r;
  const float two_nm = (float)(2.0 / ((double)a.n_total * m));
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

  for (int k = t; k < K; k += kThreads) { c_s[k] = a.coef[k]; cacc[k] = 0.f; }
  for (int q = t; q < 3 * R; q += kThreads) { om_s[q] = a.omega[q]; oacc[q] = 0.f; }
  for (int e = t; e < L.kk; e += kThreads) gb_s[e] = a.gb[e];
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
    xb_tile<KP>(a.xp, a.work + L.bp, L.mp, m, K, r0, rows, ring, Y_s, ld);
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
      a.dl[(long long)(r0 + i) * R + jl] = trig + poly;
    }
    // Gram partials over the tile's rows: the seeds' diagonal blocks of AᵀA,
    // kGroup entries side by side, and their latent Grams latᵀlat; entry e
    // = k1 Ks + k2' of the blocks stacked (S Ks, Ks), k1 the global column,
    // its seed's block from the column table (no second division)
    for (int e0 = 0; e0 < L.kk; e0 += kGroup * kThreads) {
      int k1[kGroup], k2[kGroup];
      float g[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int e = min(e0 + t + kThreads * u, L.kk - 1);
        k1[u] = e / Ks;
        k2[u] = ct[k1[u] * CT] * Ks + e % Ks;
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

template <int KP, bool kFourier, bool kPacked>
__global__ void __launch_bounds__(kThreads, 1) step_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  PhaseClock clock(reinterpret_cast<unsigned long long*>(shared_base() + kLayoutFloats));
  const int nc = kFourier ? 2 * a.nf + 1 : 0;
  Layout* shared_layout = reinterpret_cast<Layout*>(shared_base());
  if (threadIdx.x == 0)
    *shared_layout = make_layout(a.n, a.m, a.r, seed_width<kPacked>(a), seed_count<kPacked>(a), nc, gridDim.x);
  const int s = *a.count;  // read by every block before block 0 advances it
  const bool update = s > 0;
  __syncthreads();
  const Layout& L = *shared_layout;
  const Tables tb = build_tables<kPacked>(a, shared_base() + kLayoutFloats + kClockFloats);
  float* smem = shared_base() + table_floats(a.K, a.P, seed_count<kPacked>(a) * a.r);  // each phase's own shared memory
  clock.mark(kSetup);

  // the prologue: the update of step s - 1 (when s > 0), then gb = B Bᵀ
  if (update) phi_update<kPacked>(a, tb.hyp);
  slab_phase<kFourier, kPacked>(a, L, tb.hyp, smem, update);
  grid.sync();
  clock.mark(kUpdate);
  if (kFourier && update) {
    reduce_partials(a.work + L.part_ser, L.es_ser, L.es_ser, a.work + L.sums_ser, smem, L.es_ser);
    __syncthreads();
    if (blockIdx.x == 0) finalize<kPacked>(a, L, tb, smem, s);
    grid.sync();
    float* zc_s = smem;
    float* per_s = zc_s + round4(a.K * nc);
    series_update(a, L, tb.hyp, tb.hyp[kHypBias * kMaxSeeds], zc_s, per_s);
    if (a.rows) series_slab<kPacked>(a, L, zc_s, per_s, per_s + round4(a.K));
    grid.sync();
    clock.mark(kUpdate);
    if (a.rows) reduce_partials(a.work + L.part_gb, L.kk, L.kk, a.gb, smem, L.kk);
    if (blockIdx.x == 0) store_series(a, L);
  } else {
    if (a.rows) reduce_partials(a.work + L.part_gb, L.kk, L.kk, a.gb, smem, L.kk);
    __syncthreads();
    if (update && blockIdx.x == 0) finalize<kPacked>(a, L, tb, smem, s);
  }
  if (a.rows) {
    grid.sync();
    clock.mark(kGram);
    // the partials of step s over the rank's rows
    row_phase<KP, kPacked>(a, L, tb, smem, clock);
    grid.sync();
    clock.mark(kRowsBarrier);
    const long long km = (long long)a.K * a.m;
    reduce_partials(a.work + L.part, L.es, L.es, a.sums + km, smem, L.kk + L.lg);
    if (blockIdx.x == 0) {
      float v = 0.f;
      for (int bb = threadIdx.x; bb < (int)gridDim.x; bb += kThreads) v = max_nan(v, a.work[L.part_max + bb]);
      v = block_max(v, smem);
      if (threadIdx.x == 0 && s < a.num_steps) a.max_arg[s] = v;
    }
    clock.mark(kReduce);
    ax_partials<KP>(a.work + L.a, L.lda, a.xp, L.mp, a.n, a.m, a.K, L.ax, smem, a.work + L.axp);
    clock.mark(kAx);
    grid.sync();
    clock.mark(kAxBarrier);
    // ax: the split's partials summed in row-group order by the column's owner
    const float* axp = a.work + L.axp;
    const long long stride = (long long)gridDim.x * kThreads;
    for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < km; e += stride) {
      float v = 0.f;
      for (int gi = 0; gi < L.ax.gr; ++gi) v += axp[(long long)gi * km + e];
      a.sums[e] = v;
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) *a.count = s + 1;
    clock.mark(kAxSum);
  } else {
    clock.mark(kGram);
  }
  clock.store(a.work + L.timer);
}

size_t smem_bytes(int r, int Ks, int S, int P, int nc) {
  return sizeof(float) * (size_t)smem_floats(r, Ks, S, P, nc);
}

using KernelFn = void (*)(Args);

template <bool kFourier, bool kPacked>
KernelFn kernel_for_k(int K) {
  switch (padded_k(K)) {
    case 32: return step_kernel<32, kFourier, kPacked>;
    case 48: return step_kernel<48, kFourier, kPacked>;
    case 64: return step_kernel<64, kFourier, kPacked>;
    default: return step_kernel<128, kFourier, kPacked>;
  }
}

// the kernel of the packed width K = S Ks: a one-seed form at S = 1
KernelFn kernel_for(int K, int nf, int S) {
  if (S > 1) return nf > 0 ? kernel_for_k<true, true>(K) : kernel_for_k<false, true>(K);
  return nf > 0 ? kernel_for_k<true, false>(K) : kernel_for_k<false, false>(K);
}

// as train_chunk.cu valid_shape
bool valid_shape(int r, int P, int Ks, int S, int nf) {
  return r >= 1 && r <= kMaxR && P >= 1 && P <= kMaxP && S >= 1 && S <= kMaxSeeds && Ks > 3 * r &&
         S * Ks <= kMaxK && nf >= 0 && nf <= kMaxNf;
}

int series_length(int nf) { return nf > 0 ? 2 * nf + 1 : 0; }

}  // namespace

extern "C" {

// Blocks of the cooperative launch on the current device (one per SM), or a
// negative cudaError_t: cooperative launch unsupported, or no block fits.
// Ks = T + 3r columns per seed, S seeds; nf is the number of Fourier
// harmonics, 0 for the desmo form. Also sets the kernel's dynamic shared
// memory limit, which desmo_step needs (and does not set itself, so that a
// step can be captured in a graph).
int desmo_step_grid(int r, int P, int Ks, int S, int nf) {
  if (!valid_shape(r, P, Ks, S, nf)) return -(int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return -(int)err;
  if (!coop) return -(int)cudaErrorNotSupported;
  const size_t bytes = smem_bytes(r, Ks, S, P, series_length(nf));
  const void* kernel = (const void*)kernel_for(S * Ks, nf, S);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes);
  if (err != cudaSuccess) return -(int)err;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  return sms;
}

// Floats of scratch the launch needs for n rows and a grid of `grid` blocks.
long long desmo_step_workspace(int n, int m, int r, int Ks, int S, int nf, int grid) {
  return make_layout(n, m, r, Ks, S, series_length(nf), grid).total;
}

// Offset (in floats) in the scratch of the kPhases 64-bit nanosecond
// counters (enum Phase) that every launch adds its clock to.
long long desmo_step_timer_offset(int n, int m, int r, int Ks, int S, int nf, int grid) {
  return make_layout(n, m, r, Ks, S, series_length(nf), grid).timer;
}

// One step of S seeds of Ks columns each over this rank's n rows (see the
// top of this file), in place on the state (phi, coef, omega, svec and
// either b (desmo, nf = 0; tpts, ser and per unused) or ser and per
// (Fourier, nf > 0; b unused)), sums, dl, gb, the metrics and max_arg rows
// and the counter; n_total is the global row count. ctab is kernel_table's:
// the column table, then the polynomial backward's lane lists. xp holds X's
// rows at stride padded_m(m), zero beyond m; met and max_arg have num_steps
// rows (a launch past them writes none). rows = 0 runs the prologue alone.
// desmo_step_grid must have run for this shape on the device. Returns a
// cudaError_t.
int desmo_step(const float* pod, const float* xp, const float* x_sq, const int* ctab, const float* tpts,
               float* phi, float* b, float* ser, float* per, float* coef, float* omega, float* svec,
               float* sums, float* dl, float* gb, float* met, float* max_arg, int* count, float* work,
               int n, int m, int r, int P, int Ks, int S, int nf, int n_total, int rows, int sched_every,
               int num_steps, int grid, float patience, float factor, float min_lr, void* stream) {
  if (!valid_shape(r, P, Ks, S, nf) || n < 1 || m < 1 || n_total < n || grid < 1 || sched_every < 1 ||
      num_steps < 1 || !ctab || !count || (nf > 0 ? (!tpts || !ser || !per) : !b))
    return (int)cudaErrorInvalidValue;
  Args args{pod, xp, x_sq, ctab, phi, b, coef, omega, svec, sums, dl, gb, met, max_arg, count, work,
            n, m, r, P, S * Ks, n_total, rows != 0, sched_every, num_steps, patience, factor, min_lr,
            tpts, ser, per, nf, S, Ks};
  const size_t bytes = smem_bytes(r, Ks, S, P, series_length(nf));
  void* params[] = {&args};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)kernel_for(S * Ks, nf, S), dim3(grid), dim3(kThreads),
                                                params, bytes, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
