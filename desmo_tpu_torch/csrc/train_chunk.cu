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
// reads X (15.9 MB) once:
// about 11.6 us at the 67 TFLOP/s fp32 rate outside the tensor cores, with
// the X read (4.7 us at 3.35 TB/s) hidden under it. fp32-FMA-bound; X stays
// in the 50 MB L2 from one epoch to the next.
//
// Design (simple first; wgmma/TMA and 3xTF32 are later work). The TPU's
// sequential grid (num_steps + 1, row tiles) becomes a loop inside one
// persistent cooperative launch of one block per SM; the grid size is an
// argument and every split derives from it. The kernel is compiled for K
// padded to 32, 48, 64 or 128, so its register tiles fit K. Per epoch, four
// phases with a grid-wide barrier after each:
//   1. rows: each block owns a contiguous row range. In tiles of kRT rows it
//      builds lat = pod * phiᵀ, the library D and A = D * c in shared memory,
//      writes A to scratch, forms xb = X Bᵀ for its rows (chunks of X and B
//      staged in shared memory, the next chunk loaded into registers
//      meanwhile), dA = 2/nm (A gb - xb), the per-row latent gradient dl, and
//      per-block partials of AᵀA, latᵀlat, the coefficient and omega
//      gradients and max |omega * lat|;
//   2. reduce: the partials are summed over the blocks, one warp per entry;
//   3. columns: each block applies the phi Adamax to its own rows (the ortho
//      sign needs the reduced latᵀlat), then for its slab of columns forms
//      ax = Aᵀ X (A read back from L2 in prefetched tiles, each thread
//      holding up to 4 k x 8 columns), its share of sum(ax * B), gB = 2/nm
//      (ga B - ax), the B Adamax, and its partial of the next epoch's B Bᵀ;
//   4. finalize: the B Bᵀ partials are summed; block 0 writes the metrics
//      row, steps the coefficient and omega Adamax and the scheduler.
// Every sum across threads or blocks runs in a fixed order, so two launches
// give identical bits. At one block of 8 warps per SM most loops wait on
// latency: the designs above keep several loads or FMA chains in flight per
// thread. A per-phase clock (PhaseClock) says where the time goes. Products are plain fp32 FMA (the TPU's bf16 hi/lo
// three-pass products, 128-lane AUG/WIDE packing, selection matmuls and
// gathers, VMEM budgets and fast sin/cos do not carry over). Trig is CUDA's
// full-range sincosf/tanhf (no fast math); the polynomial backward uses the
// product rule over the P factors, so it needs no guard at lat == 0. The
// kernel allocates nothing and does not synchronise; the entry point returns
// the launch's cudaError_t.
//
// The Fourier form (a template parameter, so the desmo form's code is as it
// was; its fields sit at the end of Args, since placing them among the desmo
// form's slowed that form, which runs at 255 registers). B (K, m) is no parameter there but the truncated series of each row,
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
// Six grid barriers per epoch against the desmo form's four. Rebuilding all
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

// The kernel is compiled for K padded to KP = 32, 48, 64 or 128, so that the
// register tiles and loops over k have fixed sizes.
__host__ __device__ constexpr int padded_k(int K) { return K <= 32 ? 32 : K <= 48 ? 48 : K <= 64 ? 64 : 128; }
// rows per staged tile of the columns phase
__host__ __device__ constexpr int ax_tile_rows(int KP) { return KP <= 64 ? 128 : 64; }
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
// update, ax, and the rest up to the end of its barrier; the finalize phase;
// the Fourier form's series update and its B Bᵀ reduction
enum Phase {
  kPrologue, kRowsDictionary, kRowsXb, kRowsGradients, kRowsBarrier, kReduce,
  kColumnsPhi, kColumnsAx, kColumnsBarrier, kFinalize, kSeries, kSeriesGram, kPhases
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

// Offsets (in floats) into the scratch buffer for a grid of G blocks; nc is
// the Fourier form's series length 2 nf + 1, 0 for the desmo form.
struct Layout {
  long long a, dl, part, part_max, part_cross, part_gb, sums, gb;
  long long bw, part_ser, sums_ser, ser_next, timer, total;
  int kk;      // entries of the seeds' diagonal Gram blocks, S Ks²
  int lg;      // entries of the seeds' latent Grams, S r²
  int es;      // entries of the summed partials: ga, latᵀlat, gcoef, gomega
  int es_ser;  // Fourier: entries of a series partial, K (nc + 1)
};

__host__ __device__ inline Layout make_layout(int n, int m, int r, int Ks, int S, int nc, int G) {
  Layout L;
  const int K = S * Ks, R = S * r;
  L.kk = S * Ks * Ks;
  L.lg = S * r * r;
  L.es = L.kk + L.lg + K + 3 * R;
  L.es_ser = nc > 0 ? K * (nc + 1) : 0;
  const long long fourier = nc > 0;
  long long o = 0;
  L.a = o;          o += (long long)n * K;
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
  L.total = o;
  return L;
}

__host__ __device__ inline int round4(int v) { return (v + 3) / 4 * 4; }

// Shared memory that lives through the launch: the column table (K, kCT + P)
// and, for each latent lane j (of S r), the (column, factor) entries of the
// table that hold lane j + 1 (offsets and entries), for the polynomial
// backward; then the Fourier form's series LRs of the epoch, per seed.
__host__ __device__ inline int table_floats(int K, int P, int R) {
  return round4(K * (kCT + P)) + round4(R + 1) + round4(K * P) + 2 * kMaxSeeds;
}

// Shared floats: the tables, then the largest of the phases' own.
__host__ __device__ inline int smem_floats(int r, int Ks, int S, int P, int nc) {
  const int K = S * Ks, R = S * r, ld = K + 1, KP = padded_k(K), kk = S * Ks * Ks;
  const int rows = round4(K) + round4(3 * R) + round4(kk) + kRT * (R + 1) +
                   4 * kRT * ld + kRT * (kCW + 1) + KP * (kCW + 1) + kThreads + round4(K) +
                   round4(3 * R);
  const int rt3 = ax_tile_rows(KP);
  const int columns = round4(kk) + rt3 * K + KP + rt3 * kSW + 3 * K * kSW + kWarps * K * kSW + kThreads +
                      S * kThreads + (nc > 0 ? kSerTab : 0);
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
// barrier also takes in the wait for the slowest block. N counters: the
// desmo form keeps none for the Fourier form's phases (every thread carries
// them, and the kernel is at its register limit).
template <int N>
struct PhaseClock {
  unsigned long long ns[N] = {};
  unsigned long long last = 0;
  bool on;
  __device__ PhaseClock() : on(blockIdx.x == 0 && threadIdx.x == 0) {
    if (on) last = globaltimer_ns();
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
    for (int p = 0; p < N; ++p) out[p] = ns[p];
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
};

__device__ Tables build_tables(const Args& a, float* smem) {
  Tables tb;
  const int K = a.K, P = a.P, CT = kCT + P, R = a.S * a.r;
  tb.ct = reinterpret_cast<int*>(smem);
  tb.d_off = tb.ct + round4(K * CT);
  tb.d_tp = tb.d_off + round4(R + 1);
  tb.lr_ep = reinterpret_cast<float*>(tb.d_tp + round4(K * P));
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
}

// gb[parity] = B Bᵀ from the blocks' partials.
__device__ void reduce_gb(const Args& a, const Layout& L, int parity, float* red) {
  reduce_partials(a.work + L.part_gb, L.kk, L.kk, a.work + L.gb + (long long)parity * L.kk, red);
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
    a.b[(long long)k * m + j] = series_value(zc + k * nc, a.nf, c1, s1);
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

// Phase 1: forward, xb, dA, dl and the per-block partials over the block's rows.
template <int KP, typename Clock>
__device__ void row_phase(const Args& a, const Layout& L, const Tables& tb, float* smem, int step,
                          Clock& clock) {
  constexpr int kXC = KP / 16;                   // xb: k = tx + 16c, c < kXC
  constexpr int kPrefB1 = KP * kCW / kThreads;   // B values prefetched per thread
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
  float* X_s = p;   p += kRT * (kCW + 1);
  float* B_s = p;   p += KP * (kCW + 1);  // rows K..KP-1 stay zero
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
    for (int e = t; e < rows * K; e += kThreads) {
      const int i = e / K, k = e % K;
      A_g[(long long)(r0 + i) * K + k] = A_s[i * ld + k];
    }
    __syncthreads();
    clock.mark(kRowsDictionary);
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

// Phase 2: sums = the row phase's partials summed over the blocks.
__device__ void reduce_phase(const Args& a, const Layout& L, float* red) {
  reduce_partials(a.work + L.part, L.es, L.es, a.work + L.sums, red);
}

// Phase 3: phi Adamax of the block's rows; ax and gB over the block's column
// slab, then the B Adamax and the next B Bᵀ partial (desmo) or the series
// gradient partials (Fourier).
template <int KP, bool kFourier, typename Clock>
__device__ void column_phase(const Args& a, const Layout& L, float* smem, Clock& clock) {
  constexpr int kRT3 = ax_tile_rows(KP);
  constexpr int kKq = (KP + 31) / 32;              // ax: lane owns k = lane + 32q, q < kKq
  constexpr int kPrefA3 = kRT3 * KP / kThreads;    // A values prefetched per thread
  constexpr int kPrefX3 = kRT3 * kSW / kThreads;   // X values prefetched per thread
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

  float* ga_s = smem;
  float* p = smem + round4(L.kk);
  float* As = p;   p += kRT3 * K + KP;  // lanes with k >= K read past the tile and are dropped
  float* Xs = p;   p += kRT3 * kSW;     // 16-byte aligned: rows are read as float4
  float* Bo = p;   p += K * kSW;
  float* Bn = p;   p += K * kSW;
  float* ax_s = p; p += K * kSW;
  float* wred = p; p += kWarps * K * kSW;
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
  const int lane = t % 32, warp = t / 32;
  for (int j0 = col_begin; j0 < col_end; j0 += kSW) {
    const int w = min(kSW, col_end - j0);
    // ax[k][jj] over all rows: lane owns k = lane + 32q and all kSW columns,
    // warp owns the rows of each staged tile that are warp mod kWarps. The
    // next tile of A and X is loaded into registers while this one is used.
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
      for (int i = warp; i < rows; i += kWarps) {
        const float4 lo = reinterpret_cast<const float4*>(Xs + i * kSW)[0];
        const float4 hi = reinterpret_cast<const float4*>(Xs + i * kSW)[1];
        const float xv[kSW] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int q = 0; q < kKq; ++q) {
          const float av = As[i * K + lane + 32 * q];
#pragma unroll
          for (int jj = 0; jj < kSW; ++jj) acc[q][jj] = fmaf(av, xv[jj], acc[q][jj]);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kKq; ++q) {
      const int k = lane + 32 * q;
      if (k < K)
#pragma unroll
        for (int jj = 0; jj < kSW; ++jj) wred[(warp * K + k) * kSW + jj] = acc[q][jj];
    }
    for (int e = t; e < K * kSW; e += kThreads) {
      const int k = e / kSW, jj = e % kSW;
      Bo[e] = jj < w ? a.b[(long long)k * m + j0 + jj] : 0.f;
    }
    __syncthreads();
    for (int o = t; o < K * kSW; o += kThreads) {
      float sum = 0.f;
      for (int ww = 0; ww < kWarps; ++ww) sum += wred[ww * K * kSW + o];  // in warp order
      ax_s[o] = sum;
    }
    __syncthreads();
    clock.mark(kColumnsAx);
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
  const Layout L = make_layout(a.n, a.m, a.r, a.Ks, a.S, nc, gridDim.x);
  if (kFourier) a.b = a.work + L.bw;
  PhaseClock<kFourier ? kPhases : kSeries> clock;
  const Tables tb = build_tables(a, shared_base());
  float* smem = shared_base() + table_floats(a.K, a.P, a.S * a.r);  // each phase's own shared memory
  float* zc_s = smem + round4(a.K * kSW);           // Fourier, series phase
  float* per_s = zc_s + round4(a.K * nc);
  if (kFourier)
    series_slab(a, L, a.ser, a.per, smem);
  else
    gb_partial(a, L, smem);
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
      reduce_partials(a.work + L.part_ser, L.es_ser, L.es_ser, a.work + L.sums_ser, smem);
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

}  // extern "C"
