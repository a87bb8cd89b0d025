// One optimizer step of DESMO over one rank's rows, in one cooperative
// launch: the replicated update of the previous step from its all-reduced
// sums (a prologue), then this step's forward and gradient partials over the
// rank's rows. Between two launches the ranks all-reduce the partial sums
// with one SUM (desmo_tpu_torch/kernels/shard_step.py, which holds the plain
// version of this kernel beside its wrapper).
//
// Replaces the TPU kernel desmo_tpu/pallas/shard_step.py:74 _make_step_kernel
// and the replicated update that the reference runs as fused XLA operations
// between its launches (shard_step.py:318-409), one seed, desmo and Fourier
// forms. With nm = n_total * m the global count and s the launch's step
// counter (a device integer: the launches with rows so far in the chunk, so
// that a CUDA graph of one step can replay it):
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
// Design. One persistent cooperative launch of one block per SM, the
// single-device mega-kernel's phases (csrc/train_chunk.cu) for one seed,
// each routine a copy of its counterpart there (marked "as train_chunk.cu
// <name>"), rearranged so that the update comes first:
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
constexpr int kCT = 4;            // column table: seed, kind (0 polynomial, 1 sin, 2 cos, 3 tanh),
                                  // latent lane, omega slot, then the P factor lanes
constexpr int kMetrics = 4;       // rec, ortho, l1, total
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
// scheduler-vector slots
constexpr int kSvec = 16;
constexpr int kLr0 = 0, kBest = 5, kPow = 6, kCount = 7, kNumBad = 8, kEpoch = 9, kBeta = 10, kLam = 11;

struct Args {
  const float* pod;   // (n, r): this rank's rows
  const float* xp;    // (n, mp): this rank's rows of X, padded to mp = padded_m(m) with zeros
  const float* x_sq;  // sum(X * X) over every rank's rows
  const int* ctab;    // the column table of one seed (K, kCT + P), then the lane lists: d_off (r + 1), d_tp (K P)
  float* phi;         // (3, r, n): phi, mu, nu of this rank's rows
  float* b;           // desmo: (3, K, m) B, mu, nu; unused in the Fourier form
  float* coef;        // (3, K)
  float* omega;       // (3, 3r)
  float* svec;        // (kSvec) scheduler vector
  float* sums;        // (K m + K K + r r + K + 3r): ax, ga, latᵀlat, gcoef, gomega
  float* dl;          // (n, r)
  float* gb;          // (K, K) = B Bᵀ of the B the last partials used
  float* met;         // (num_steps, kMetrics)
  float* max_arg;     // (num_steps)
  int* count;         // the step counter s
  float* work;        // scratch, make_layout(...).total floats
  int n, m, r, P, K, n_total, rows, sched_every, num_steps;  // rows s of met and max_arg exist for s < num_steps
  float patience, factor, min_lr;
  // the Fourier form's (nf > 0; nf = 0 is the desmo form)
  const float* tpts;  // (m,) t_points
  float* ser;         // (3, K, nc) series coefficients, mu, nu
  float* per;         // (3, K) periods, mu, nu
  int nf;
};

__host__ __device__ inline int round4(int v) { return (v + 3) / 4 * 4; }
__host__ __device__ inline int padded_m(int m) { return (m + 7) / 8 * 8; }

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
  int kk;      // K²
  int es;      // entries of a block's partial: ga, latᵀlat, gcoef, gomega
  int es_ser;  // Fourier: entries of a series partial, K (nc + 1)
  int lda;     // row stride of A (n, K) in the scratch, round4(K): 16-byte rows, zero from K on
  int mp;      // row stride of the padded copies of X and B: 32-byte rows, zero from m on
  AxSplit ax;  // the AᵀX split; its partials (gr, K, m) at axp
};

__host__ __device__ inline Layout make_layout(int n, int m, int r, int K, int nc, int G) {
  Layout L;
  L.lda = round4(K);
  L.ax = ax_split(n, m, G);
  L.kk = K * K;
  L.es = L.kk + r * r + K + 3 * r;
  L.es_ser = nc > 0 ? K * (nc + 1) : 0;
  const long long fourier = nc > 0;
  long long o = 0;
  L.a = o;          o += (long long)n * L.lda;
  L.part = o;       o += (long long)G * L.es;
  L.part_max = o;   o += G;
  L.part_cross = o; o += G;
  L.part_gb = o;    o += (long long)G * L.kk;
  L.part_ser = o;   o += (long long)G * L.es_ser;
  L.sums_ser = o;   o += L.es_ser;
  L.ser_next = o;   o += fourier * 3LL * K * (nc + 1);  // series (3, K, nc), then periods (3, K)
  L.gagb = o;       o += 1;
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
constexpr int kHyp = 8;  // the launch's LRs (5), Adamax bias, beta, lambda

// Shared memory that lives through the launch: the Layout; the kernel
// clock's counters; the column table and, for each latent lane j, the
// entries of the table that hold lane j + 1 (offsets and entries), for the
// polynomial backward; the launch's hyperparameters.
constexpr int kClockFloats = (2 * kPhases + 3) / 4 * 4;
__host__ __device__ inline int table_floats(int K, int P, int r) {
  return kLayoutFloats + kClockFloats + round4(K * (kCT + P)) + round4(r + 1) + round4(K * P) + kHyp;
}

// Shared floats: the tables, then the largest of the phases' own.
__host__ __device__ inline int smem_floats(int r, int K, int P, int nc) {
  const int ld = K + 1, KP = padded_k(K), kk = K * K;
  const int rows = round4(K) + round4(3 * r) + round4(kk) + kRT * (r + 1) + 4 * kRT * ld + xb_ring_floats(KP) +
                   kThreads + round4(K) + round4(3 * r);
  const int slab = round4(kk) + 3 * K * kSW + kThreads + (nc > 0 ? kSerTab : 0);
  const int series = round4(K * nc) + round4(K) + K * kSW;
  int most = rows > ax_ring_floats(KP) ? rows : ax_ring_floats(KP);
  most = most > slab ? most : slab;
  most = most > series ? most : series;
  return table_floats(K, P, r) + most;
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
// holds them; hyp holds the launch's LRs, bias, beta and lambda, read before
// block 0's scheduler step. The host builds the lane lists
// (kernels/shard_step.py kernel_table: they depend on the shape alone), so
// a launch only copies them in; train_chunk.cu build_tables forms them once
// a chunk, which would take a fifth of a launch at cylinder here.
struct Tables {
  int* ct;
  int* d_off;
  int* d_tp;
  float* hyp;  // lr_coef, lr_phi, lr_z, lr_omega, lr_period, bias, beta, lam
};

__device__ Tables build_tables(const Args& a, float* smem) {
  Tables tb;
  const int K = a.K, P = a.P, CT = kCT + P, R = a.r;
  tb.ct = reinterpret_cast<int*>(smem);
  tb.d_off = tb.ct + round4(K * CT);
  tb.d_tp = tb.d_off + round4(R + 1);
  tb.hyp = reinterpret_cast<float*>(tb.d_tp + round4(K * P));
  const int* lanes = a.ctab + K * CT;
  for (int e = threadIdx.x; e < K * CT; e += kThreads) tb.ct[e] = a.ctab[e];
  for (int e = threadIdx.x; e < R + 1; e += kThreads) tb.d_off[e] = lanes[e];
  for (int e = threadIdx.x; e < K * P; e += kThreads) tb.d_tp[e] = lanes[R + 1 + e];
  if (threadIdx.x < 5) tb.hyp[threadIdx.x] = a.svec[kLr0 + threadIdx.x];
  if (threadIdx.x == 5) tb.hyp[5] = 1.f - a.svec[kPow] * kB1;
  if (threadIdx.x == 6) tb.hyp[6] = a.svec[kBeta];
  if (threadIdx.x == 7) tb.hyp[7] = a.svec[kLam];
  __syncthreads();
  return tb;
}

// as train_chunk.cu accumulate_gb (one seed): part_gb[k1 K + k2] += the sum
// over the sub-slab's w columns of bn[k1][jj] * bn[k2][jj]
__device__ void accumulate_gb(const float* bn, int w, int K, float* part_gb) {
  for (int e = threadIdx.x; e < K * K; e += kThreads) {
    const int k1 = e / K, k2 = e % K;
    float g = part_gb[e];
    for (int jj = 0; jj < w; ++jj) g = fmaf(bn[k1 * kSW + jj], bn[k2 * kSW + jj], g);
    part_gb[e] = g;
  }
}

// as train_chunk.cu reduce_partials: out[e] = the sum over the grid's blocks
// b of part[b * stride + e], for e < count: one warp per entry, lane l adding
// partials l, l + 32, ... in order, then the 32 lane sums added in lane
// order; every thread of the block must call it.
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

// as train_chunk.cu series_update (one seed): the series and period Adamax
// from the reduced gradients and the old state, into shared memory in every
// block (zc_s (K, nc), per_s (K)), with the launch's LRs and bias; block 0
// also writes the new state with its moments to the scratch (ser_next),
// which store_series stores after the next grid barrier
__device__ void series_update(const Args& a, const Layout& L, const float* hyp, float* zc_s, float* per_s) {
  const int K = a.K, nc = 2 * a.nf + 1, NC = nc + 1;
  const float* sums = a.work + L.sums_ser;
  float* next = a.work + L.ser_next;
  const long long kn = (long long)K * nc;
  const bool store = blockIdx.x == 0;
  const float bias = hyp[5];
  for (int e = threadIdx.x; e < K * nc; e += kThreads) {
    float p = a.ser[e], mu = a.ser[kn + e], nu = a.ser[2 * kn + e];
    adamax(&p, &mu, &nu, sums[(e / nc) * NC + e % nc], hyp[2], bias);
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
    adamax(&p, &mu, &nu, g, hyp[4], bias);
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
__device__ void store_b_slab(const Args& a, const Layout& L, const float* bn, int j0, int w, float* part_gb) {
  for (int o = threadIdx.x; o < a.K * kSW; o += kThreads) {
    const int k = o / kSW, jj = o % kSW;
    if (jj < w) a.work[L.bp + (long long)k * L.mp + j0 + jj] = bn[o];
  }
  accumulate_gb(bn, w, a.K, part_gb);
}

// P1, the block's rows of phi (when update): one thread per row, as
// train_chunk.cu column_phase's phi step (one seed), with step s - 1's dl and
// the summed latent Gram's signs.
__device__ void phi_update(const Args& a, const float* hyp) {
  const int n = a.n, r = a.r, G = gridDim.x;
  const float* latg = a.sums + (long long)a.K * a.m + (long long)a.K * a.K;
  const float lr_phi = hyp[1], bias = hyp[5], beta = hyp[6];
  const int Rw = (n + G - 1) / G, row_begin = blockIdx.x * Rw, row_end = min(n, row_begin + Rw);
  const long long rn = (long long)r * n;
  for (int row = row_begin + threadIdx.x; row < row_end; row += kThreads) {
    float lat[kMaxR], pd[kMaxR];
    for (int j = 0; j < r; ++j) pd[j] = a.pod[(long long)row * r + j];
    for (int j = 0; j < r; ++j) lat[j] = pd[j] * a.phi[(long long)j * n + row];
    for (int j = 0; j < r; ++j) {
      float dlo = 0.f;
      for (int l = 0; l < r; ++l)
        if (l != j) dlo = fmaf(lat[l], sgn(latg[l * r + j]), dlo);
      const float g = (a.dl[(long long)row * r + j] + beta * dlo) * pd[j];
      const long long o = (long long)j * n + row;
      adamax(a.phi + o, a.phi + rn + o, a.phi + 2 * rn + o, g, lr_phi, bias);
    }
  }
}

// P1, the block's column slab, in sub-slabs of kSW columns: the old B (desmo:
// the state's; Fourier: from the old series) and, when update, the summed ax,
// this block's partial of sum(ax * B), gB = 2/nm (ga B - ax) and the B Adamax
// (desmo; as train_chunk.cu column_phase's slab, one seed) or the series
// gradient partials (Fourier); block 0 also forms sum(ga * gb) of the old gb
// for the metrics. Then, when rows and B is final here (desmo, or the
// Fourier form without an update), the slab of B into its padded copy and
// its B Bᵀ partial.
template <bool kFourier>
__device__ void slab_phase(const Args& a, const Layout& L, const float* hyp, float* smem, bool update) {
  const int t = threadIdx.x, b = blockIdx.x;
  const int m = a.m, K = a.K;
  const float two_nm = (float)(2.0 / ((double)a.n_total * m));
  const float bias = hyp[5], lr_z = hyp[2];
  float* ga_s = smem;
  float* p = smem + round4(K * K);
  float* Bo = p;   p += K * kSW;
  float* Bn = p;   p += K * kSW;
  float* ax_s = p; p += K * kSW;
  float* red = p;  p += kThreads;
  float* tab = p;  // Fourier: kSerTab floats
  const bool gram = a.rows && !(kFourier && update);
  float* part_gb = a.work + L.part_gb + (long long)b * L.kk;
  float* part_ser = a.work + L.part_ser + (long long)b * L.es_ser;
  const long long km = (long long)K * m;
  if (update) {
    for (int e = t; e < L.kk; e += kThreads) ga_s[e] = a.sums[km + e];
    if (kFourier)
      for (int e = t; e < L.es_ser; e += kThreads) part_ser[e] = 0.f;
    if (b == 0) {  // sum(ga * gb) of the old gb, before P2 writes the new: 32 lanes, added in lane order
      __syncthreads();
      float v = 0.f;
      if (t < 32)
        for (int e = t; e < L.kk; e += 32) v = fmaf(ga_s[e], a.gb[e], v);
      red[t] = v;
      __syncthreads();
      if (t == 0) {
        float u = 0.f;
        for (int l = 0; l < 32; ++l) u += red[l];
        a.work[L.gagb] = u;
      }
    }
  }
  if (gram) {
    for (int e = t; e < L.kk; e += kThreads) part_gb[e] = 0.f;
    zero_b_pad(a, L);
  }
  float cross = 0.f;
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
      for (int o = t; o < K * kSW; o += kThreads) {
        const int k = o / kSW, jj = o % kSW;
        float nb = 0.f;
        if (jj < w) {
          cross = fmaf(ax_s[o], Bo[o], cross);
          float sm = 0.f;
          for (int l = 0; l < K; ++l) sm = fmaf(ga_s[k * K + l], Bo[l * kSW + jj], sm);
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
      __syncthreads();
      if (kFourier) series_partial(a, Bn, j0, w, tab, part_ser);
    }
    if (gram) store_b_slab(a, L, update ? Bn : Bo, j0, w, part_gb);
  }
  if (update) {
    cross = block_sum(cross, red);
    if (t == 0) a.work[L.part_cross + b] = cross;
  }
}

// P2, block 0: as train_chunk.cu seed_sums and finalize (one seed): the
// metrics row s - 1 of the pre-update parameters (sum(ga * gb) from P1, the
// grid's sum(ax * B) partials, the sum of |latᵀlat| off the diagonal and
// sum |c|, each by one warp with its lane sums added in lane order), the
// coefficient and omega Adamax and the plateau scheduler.
__device__ void finalize(const Args& a, const Layout& L, const Tables& tb, float* smem, int s) {
  const int t = threadIdx.x, lane = t % 32, warp = t / 32, G = gridDim.x;
  const int r = a.r, K = a.K;
  float* red = smem;
  float* ss = smem + kThreads;  // the four sums, then the total
  const float* ga = a.sums + (long long)K * a.m;
  const float* latg = ga + L.kk;
  const float* gcoef = latg + r * r;
  const float* gom = gcoef + K;
  float* sv = a.svec;
  const float powb = sv[kPow] * kB1;
  const float bias = 1.f - powb;
  {
    float v = 0.f;
    if (warp == 0) {
      v = lane == 0 ? a.work[L.gagb] : 0.f;
    } else if (warp == 1) {
      for (int bb = lane; bb < G; bb += 32) v += a.work[L.part_cross + bb];
    } else if (warp == 2) {
      for (int e = lane; e < r * r; e += 32)
        if (e / r != e % r) v += fabsf(latg[e]);
    } else if (warp == 3) {
      for (int k = lane; k < K; k += 32) v += fabsf(a.coef[k]);
    }
    red[t] = v;
    __syncthreads();
    if (lane == 0 && warp < 4) {
      float u = 0.f;
      for (int l = 0; l < 32; ++l) u += red[t + l];
      ss[warp] = u;
    }
    __syncthreads();  // the sums are written, and every read of c is done before its update
  }
  if (t == 0 && s - 1 < a.num_steps) {
    const float nm = (float)((double)a.n_total * a.m);
    const float rec = (ss[0] - 2.f * ss[1] + *a.x_sq) / nm;
    const float ortho = 0.5f * ss[2], l1 = ss[3];
    const float total = rec + sv[kBeta] * ortho + sv[kLam] * l1;
    ss[4] = total;
    float* row = a.met + (long long)(s - 1) * kMetrics;
    row[0] = rec;
    row[1] = ortho;
    row[2] = l1;
    row[3] = total;
  }
  for (int k = t; k < K; k += kThreads) {
    const float g = gcoef[k] + sv[kLam] * sgn(a.coef[k]);
    adamax(a.coef + k, a.coef + K + k, a.coef + 2 * K + k, g, sv[kLr0], bias);
  }
  for (int q = t; q < 3 * r; q += kThreads)
    adamax(a.omega + q, a.omega + 3 * r + q, a.omega + 6 * r + q, gom[q], sv[kLr0 + 3], bias);
  __syncthreads();  // every thread has read the scheduler vector, and the total is written
  if (t == 0) {
    const float total = ss[4];
    const float best = sv[kBest], num_bad = sv[kNumBad], epoch = sv[kEpoch];
    const bool improved = total < best * kImproved;
    const float best_n = improved ? total : best;
    float nb = improved ? 0.f : num_bad + 1.f;
    const bool reduce = nb > a.patience;
    if (reduce) nb = 0.f;
    if (fmodf(epoch, (float)a.sched_every) == 0.f) {
      for (int g = 0; g < 5; ++g) {
        const float lr = sv[kLr0 + g];
        sv[kLr0 + g] = reduce ? fmaxf(lr * a.factor, a.min_lr) : lr;
      }
      sv[kBest] = best_n;
      sv[kNumBad] = nb;
    }
    sv[kPow] = powb;
    sv[kCount] = sv[kCount] + 1.f;
    sv[kEpoch] = epoch + 1.f;
  }
}

// P3 (Fourier, when rows): as train_chunk.cu series_slab, the block's column
// slab of the new B from the new series zc_s (K, nc) and periods per_s (K),
// in sub-slabs, into the padded copy, and its B Bᵀ partial.
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
    store_b_slab(a, L, bn, j0, w, part_gb);
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

// R1, as train_chunk.cu row_phase (one seed): forward, xb, dA, dl and the
// per-block partials over the block's rows.
template <int KP>
__device__ void row_phase(const Args& a, const Layout& L, const Tables& tb, float* smem, PhaseClock& clock) {
  const int t = threadIdx.x, b = blockIdx.x, G = gridDim.x;
  const int n = a.n, m = a.m, r = a.r, P = a.P, K = a.K, ld = K + 1;
  const int AW = r + 1, CT = kCT + P, T = K - 3 * r;
  const float two_nm = (float)(2.0 / ((double)a.n_total * m));
  const int* ct = tb.ct;
  float* p = smem;
  float* c_s = p;   p += round4(K);
  float* om_s = p;  p += round4(3 * r);
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
  for (int q = t; q < 3 * r; q += kThreads) { om_s[q] = a.omega[q]; oacc[q] = 0.f; }
  for (int e = t; e < L.kk; e += kThreads) gb_s[e] = a.gb[e];
  for (int e = t; e < L.kk + r * r; e += kThreads) part[e] = 0.f;
  float vmax = 0.f;

  const int Rw = (n + G - 1) / G, row_begin = b * Rw, row_end = min(n, row_begin + Rw);
  for (int r0 = row_begin; r0 < row_end; r0 += kRT) {
    const int rows = min(kRT, row_end - r0);
    __syncthreads();  // the tables are loaded and the previous tile is consumed
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
    for (int e = t; e < rows * L.lda; e += kThreads) {
      const int i = e / L.lda, k = e % L.lda;
      A_g[(long long)(r0 + i) * L.lda + k] = k < K ? A_s[i * ld + k] : 0.f;
    }
    __syncthreads();
    clock.mark(kRowsDictionary);
    xb_tile<KP>(a.xp, a.work + L.bp, L.mp, m, K, r0, rows, ring, Y_s, ld);
    __syncthreads();
    clock.mark(kRowsXb);
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
        for (int u = 0; u < kGroup; ++u) acc[u] = fmaf(A_s[ia[u] + l], gb_s[ka[u] + l * K], acc[u]);
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
    // product rule
    for (int e = t; e < rows * r; e += kThreads) {
      const int i = e / r, j = e % r;
      const float* ag = aug_s + i * AW;
      float trig = 0.f;
      for (int kind = 0; kind < 3; ++kind) {
        const int q = kind * r + j, k = T + q;
        trig += Y_s[i * ld + k] * c_s[k] * V_s[i * ld + k] * om_s[q];
      }
      float poly = 0.f;
      for (int d = tb.d_off[j]; d < tb.d_off[j + 1]; ++d) {
        const int tt = tb.d_tp[d] / P, q = tb.d_tp[d] % P;
        float prod = Y_s[i * ld + tt] * c_s[tt];
        for (int u = 0; u < P; ++u)
          if (u != q) prod *= ag[ct[tt * CT + kCT + u]];
        poly += prod;
      }
      a.dl[(long long)(r0 + i) * r + j] = trig + poly;
    }
    // Gram partials over the tile's rows: AᵀA, kGroup entries side by side,
    // and latᵀlat
    for (int e0 = 0; e0 < L.kk; e0 += kGroup * kThreads) {
      int k1[kGroup], k2[kGroup];
      float g[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int e = min(e0 + t + kThreads * u, L.kk - 1);
        k1[u] = e / K;
        k2[u] = e % K;
        g[u] = part_ga[e];
      }
      for (int i = 0; i < rows; ++i)
#pragma unroll
        for (int u = 0; u < kGroup; ++u) g[u] = fmaf(A_s[i * ld + k1[u]], A_s[i * ld + k2[u]], g[u]);
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
        if (e0 + t + kThreads * u < L.kk) part_ga[e0 + t + kThreads * u] = g[u];
    }
    for (int e = t; e < r * r; e += kThreads) {
      const int j1 = e / r, j2 = e % r;
      float g = part_lat[e];
      for (int i = 0; i < rows; ++i) g = fmaf(aug_s[i * AW + 1 + j1], aug_s[i * AW + 1 + j2], g);
      part_lat[e] = g;
    }
    __syncthreads();
    clock.mark(kRowsGradients);
  }
  for (int k = t; k < K; k += kThreads) part[L.kk + r * r + k] = cacc[k];
  for (int q = t; q < 3 * r; q += kThreads) part[L.kk + r * r + K + q] = oacc[q];
  vmax = block_max(vmax, red);
  if (t == 0) a.work[L.part_max + b] = vmax;
}

template <int KP, bool kFourier>
__global__ void __launch_bounds__(kThreads, 1) step_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  PhaseClock clock(reinterpret_cast<unsigned long long*>(shared_base() + kLayoutFloats));
  const int nc = kFourier ? 2 * a.nf + 1 : 0;
  Layout* shared_layout = reinterpret_cast<Layout*>(shared_base());
  if (threadIdx.x == 0) *shared_layout = make_layout(a.n, a.m, a.r, a.K, nc, gridDim.x);
  const int s = *a.count;  // read by every block before block 0 advances it
  const bool update = s > 0;
  __syncthreads();
  const Layout& L = *shared_layout;
  const Tables tb = build_tables(a, shared_base() + kLayoutFloats + kClockFloats);
  float* smem = shared_base() + table_floats(a.K, a.P, a.r);  // each phase's own shared memory
  clock.mark(kSetup);

  // the prologue: the update of step s - 1 (when s > 0), then gb = B Bᵀ
  if (update) phi_update(a, tb.hyp);
  slab_phase<kFourier>(a, L, tb.hyp, smem, update);
  grid.sync();
  clock.mark(kUpdate);
  if (kFourier && update) {
    reduce_partials(a.work + L.part_ser, L.es_ser, L.es_ser, a.work + L.sums_ser, smem);
    __syncthreads();
    if (blockIdx.x == 0) finalize(a, L, tb, smem, s);
    grid.sync();
    float* zc_s = smem;
    float* per_s = zc_s + round4(a.K * nc);
    series_update(a, L, tb.hyp, zc_s, per_s);
    if (a.rows) series_slab(a, L, zc_s, per_s, per_s + round4(a.K));
    grid.sync();
    clock.mark(kUpdate);
    if (a.rows) reduce_partials(a.work + L.part_gb, L.kk, L.kk, a.gb, smem);
    if (blockIdx.x == 0) store_series(a, L);
  } else {
    if (a.rows) reduce_partials(a.work + L.part_gb, L.kk, L.kk, a.gb, smem);
    __syncthreads();
    if (update && blockIdx.x == 0) finalize(a, L, tb, smem, s);
  }
  if (a.rows) {
    grid.sync();
    clock.mark(kGram);
    // the partials of step s over the rank's rows
    row_phase<KP>(a, L, tb, smem, clock);
    grid.sync();
    clock.mark(kRowsBarrier);
    const long long km = (long long)a.K * a.m;
    reduce_partials(a.work + L.part, L.es, L.es, a.sums + km, smem);
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

size_t smem_bytes(int r, int K, int P, int nc) { return sizeof(float) * (size_t)smem_floats(r, K, P, nc); }

using KernelFn = void (*)(Args);

template <bool kFourier>
KernelFn kernel_for_k(int K) {
  switch (padded_k(K)) {
    case 32: return step_kernel<32, kFourier>;
    case 48: return step_kernel<48, kFourier>;
    case 64: return step_kernel<64, kFourier>;
    default: return step_kernel<128, kFourier>;
  }
}

KernelFn kernel_for(int K, int nf) { return nf > 0 ? kernel_for_k<true>(K) : kernel_for_k<false>(K); }

bool valid_shape(int r, int P, int K, int nf) {
  return r >= 1 && r <= kMaxR && P >= 1 && P <= kMaxP && K > 3 * r && K <= kMaxK && nf >= 0 && nf <= kMaxNf;
}

int series_length(int nf) { return nf > 0 ? 2 * nf + 1 : 0; }

}  // namespace

extern "C" {

// Blocks of the cooperative launch on the current device (one per SM), or a
// negative cudaError_t: cooperative launch unsupported, or no block fits.
// Also sets the kernel's dynamic shared memory limit, which desmo_step needs
// (and does not set itself, so that a step can be captured in a graph).
int desmo_step_grid(int r, int P, int K, int nf) {
  if (!valid_shape(r, P, K, nf)) return -(int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return -(int)err;
  if (!coop) return -(int)cudaErrorNotSupported;
  const size_t bytes = smem_bytes(r, K, P, series_length(nf));
  const void* kernel = (const void*)kernel_for(K, nf);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes);
  if (err != cudaSuccess) return -(int)err;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  return sms;
}

// Floats of scratch the launch needs for n rows and a grid of `grid` blocks.
long long desmo_step_workspace(int n, int m, int r, int K, int nf, int grid) {
  return make_layout(n, m, r, K, series_length(nf), grid).total;
}

// Offset (in floats) in the scratch of the kPhases 64-bit nanosecond
// counters (enum Phase) that every launch adds its clock to.
long long desmo_step_timer_offset(int n, int m, int r, int K, int nf, int grid) {
  return make_layout(n, m, r, K, series_length(nf), grid).timer;
}

// One step over this rank's n rows (see the top of this file), in place on
// the state (phi, coef, omega, svec and either b (desmo, nf = 0; tpts, ser
// and per unused) or ser and per (Fourier, nf > 0; b unused)), sums, dl, gb,
// the metrics and max_arg rows and the counter; n_total is the global row
// count. ctab is kernel_table's: the column table, then the polynomial
// backward's lane lists. xp holds X's rows at stride padded_m(m), zero beyond m; met and
// max_arg have num_steps rows (a launch past them writes none). rows = 0
// runs the prologue alone. desmo_step_grid must have run for this shape on
// the device. Returns a cudaError_t.
int desmo_step(const float* pod, const float* xp, const float* x_sq, const int* ctab, const float* tpts,
               float* phi, float* b, float* ser, float* per, float* coef, float* omega, float* svec,
               float* sums, float* dl, float* gb, float* met, float* max_arg, int* count, float* work,
               int n, int m, int r, int P, int K, int nf, int n_total, int rows, int sched_every, int num_steps,
               int grid, float patience, float factor, float min_lr, void* stream) {
  if (!valid_shape(r, P, K, nf) || n < 1 || m < 1 || n_total < n || grid < 1 || sched_every < 1 ||
      num_steps < 1 || !ctab || !count || (nf > 0 ? (!tpts || !ser || !per) : !b))
    return (int)cudaErrorInvalidValue;
  Args args{pod, xp, x_sq, ctab, phi, b, coef, omega, svec, sums, dl, gb, met, max_arg, count, work,
            n, m, r, P, K, n_total, rows != 0, sched_every, num_steps, patience, factor, min_lr, tpts, ser, per, nf};
  const size_t bytes = smem_bytes(r, K, P, series_length(nf));
  void* params[] = {&args};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)kernel_for(K, nf), dim3(grid), dim3(kThreads), params,
                                                bytes, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
