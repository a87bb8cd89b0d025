// A whole training chunk of the AE variant in one cooperative launch:
// num_steps Adamax epochs of the encoder and decoder funnels, the dictionary
// block on the encoder's latent, the factored AE-MSE, the analytic
// gradients, the plateau scheduler and one metrics row per epoch.
//
// Replaces the TPU kernel desmo_tpu/pallas/ae_chunk.py:170 _make_ae_kernel
// (built by _build_ae_call :760, called at :878). The per-epoch semantics are
// those of the eager training step on the factored AE loss, as
// desmo_tpu_torch/kernels/ae_chunk.py sets them out beside its plain
// PyTorch version: the funnel m->256->128->64->16->8->4->2 and its mirror,
// ReLU (gradient zero at 0) but on the latent and the reconstruction; the
// tanh channel left out of the dictionary sum, the L1 and every gradient;
// ortho = s1 s2 / n²; the AE-MSE factored through the last decoder layer,
// so the (n, m) decode is never formed.
//
// Bound on an H100 SXM at ae_cylinder (n=3961, m=1001, r=2, P=2, K=12): an
// epoch needs about 11.3 GFLOP: the four products with X (X·W0, X·V6ᵀ,
// D6ᵀX, Xᵀ·dpre1) 2·n·m·256 each, 8.12 in all; the narrow funnel layers
// forward and backward, with their weight gradients, about 2.0; D6ᵀD6
// (symmetric) and D6·VV 0.78; V6V6ᵀ and S_dd·V6 0.20; the K=12 dictionary
// (X·Bᵀ, AᵀX and the Grams) 0.19. That is about 169 us at the 67 TFLOP/s
// fp32 rate outside the tensor cores. Every one of these products is
// fp32-grade work the tensor cores can do in three TF32 passes at 495
// TFLOP/s, so the bound at fp32 grade is about 68 us (chip_smoke.py's
// bound_3xtf32_ms over all 11.3 GFLOP). X (15.9 MB) fits in the 50 MB L2
// and is read four times per epoch.
//
// Design. The TPU kernel runs the whole funnel at full height in its last
// row tile, because Mosaic pays per operation; on Hopper the funnel is
// row-parallel. One persistent cooperative launch of one block of 256
// threads per SM; each block owns a contiguous range of rows, worked in
// tiles of 32. Every activation and every pre-activation gradient is
// stashed in the scratch (about 1,900 floats a row), so nothing is
// recomputed. The row phases multiply in plain fp32 FMA (row_gemm). Every
// product over the rows (the column phases) is a column job: an Lᵀ R on the
// tensor cores (col_mma.cuh's lt_r_tile: 3xTF32 mma.sync, 64 x 128 output
// tiles, each warp 2 m16 x 4 n8 tiles, operands staged by 16-byte cp.async
// through a 3-stage ring and split into big and small TF32 planes once, by
// the thread that copied them). Column sums (the biases, 1ᵀD6) are jobs with
// a column of ones for L. A job is split over row groups: each (tile, group)
// task writes a partial into the scratch, and the next phase sums a job's
// partials in group order, so two launches give identical bits. The groups
// are chosen at run time from n and G (job_groups) so that each phase's
// tasks fill the G blocks in one round; X is staged from a copy with rows
// padded to 16 bytes (xp), made once per launch, and A has rows of a
// multiple of 4 floats. Five phases per epoch, with a grid barrier after
// each:
//   0. rows: per tile, the encoder (X·W0 and the narrow layers) to the
//      latent, the decoder to D6; the dictionary on the latent, X·Bᵀ, dA,
//      the coefficient and omega gradient partials and the dictionary's
//      latent gradient; X·V6ᵀ, dD6 = k (D6·VV + c6V6ᵀ - X·V6ᵀ) and the
//      decoder backward to the latent; per-block partials of s1 and s2;
//   1. rows: the latent gradient gets the ortho term (s1, s2 summed over the
//      blocks' partials in block order, by every block alike) and the
//      encoder backward runs to dpre1; then the gram jobs' tasks: D6ᵀX,
//      D6ᵀD6, AᵀX, AᵀA and 1ᵀD6;
//   2. the weight jobs' tasks: every MLP weight and bias gradient but V6's
//      and c6's (Xᵀ·dpre1 and the narrow layers' aᵀ·g, 1ᵀ·g); the blocks
//      they leave idle sum the gram jobs' partials into S_dX, S_dd, AᵀX,
//      AᵀA and s_d;
//   3. slabs of 8 columns of m, each stepping V6 (dV6 = k (S_dd V6 + s_dᵀc6
//      - S_dX)), c6 and B and writing its partials of the metrics; and
//      <S_dd, VV>, <ga, gb>;
//   4. block 0: the metrics row, the coefficient and omega Adamax and the
//      scheduler; the other blocks: VV = V6V6ᵀ, c6V6ᵀ and B Bᵀ of the new
//      parameters, for the next epoch, then the sums of the weight jobs'
//      partials, each with its Adamax step (lr_z and the Adamax bias read
//      before the scheduler's step).
// What it does about the causes that held the column phases back (measured
// on the H100, PERF.md): each task was one output tile summed over all n
// rows by one block, 178 and 191 tasks on 132 blocks, so two rounds with the
// second mostly idle; now 124 and 132 tasks in one round. Each task walked
// its rows in 32-row chunks through registers, with two barriers per chunk,
// scalar loads of X and fp32 FMA; now the chunks arrive by cp.async ahead of
// use and the products run on the tensor cores. Every sum across threads or
// blocks runs in a fixed order. A per-phase clock (PhaseClock) says where
// the time goes. The kernel allocates nothing and does not synchronise; the
// entry point returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stddef.h>

#include "col_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kRT = 32;    // rows per tile of the row phases
constexpr int kKC = 32;    // contraction chunk of the row products
constexpr int kCP = 32;    // next epoch's Grams (col_tile): output rows per tile
constexpr int kCQ = 64;    // next epoch's Grams: output columns per tile
constexpr int kCR = 32;    // next epoch's Grams: rows of the contraction per staged chunk
constexpr int kTP = 64;    // column jobs (lt_r_tile): output rows per tile; kColTQ columns
constexpr int kSlab = 8;   // columns of m per V6 slab task
constexpr int kH = 256;    // first hidden width
constexpr int kL = 7;      // layers per side
constexpr int kR = 2;      // latent width
constexpr int kMaxK = 16;  // dictionary columns, T + 3r
constexpr int kMaxP = 8;
constexpr int kMetrics = 6;  // rec, ortho, l1, total, max |omega * lat|, ae
constexpr int kPart0 = 32;   // per-block partials of phase 0: s1, s2, max|arg|, gcoef (K), gomega (3r)
constexpr int kPart2 = 8;    // per-slab partials: <S_dX, V6>, (s_d V6)·c6, xcol·c6, |c6|², <ax, B>
// the staging of the products: the row products', or the column jobs' ring, the larger
constexpr int kGemmFloats = kKC * kRT + kKC * kH > col_ring_floats(kTP) ? kKC * kRT + kKC * kH : col_ring_floats(kTP);
constexpr int kGramJobs = 5;     // phase 1's column jobs: D6ᵀX, D6ᵀD6, AᵀX, AᵀA, 1ᵀD6
constexpr int kWeightJobs = 26;  // phase 2's: the 13 weight gradients but V6's, then the 13 bias gradients but c6's
enum Phase {
  kPrologue, kRowsForward, kRowsDictionary, kRowsDecoder, kRowsBarrier, kEncBackward, kEncColumns,
  kEncBarrier, kColWeights, kColWeightsBarrier, kColV6, kColBarrier, kFinalize, kPhases
};
constexpr float kB1 = 0.9f, kB2 = 0.999f, kEps = 1e-8f;
constexpr float kOneMinusB1 = (float)(1.0 - 0.9);
constexpr float kImproved = (float)(1.0 - 1e-4);  // plateau threshold, relative
// scheduler-vector slots (desmo_tpu_torch/kernels/train_chunk.py); group LRs coef 0, z 2, omega 3
constexpr int kLr0 = 0, kBest = 5, kPow = 6, kCount = 7, kNumBad = 8, kEpoch = 9;
constexpr int kLrCoef = 0, kLrZ = 2, kLrOmega = 3;

struct Args {
  const float* x;     // (n, m)
  const float* x_sq;  // sum(X * X)
  const float* xcol;  // (m,) column sums of X
  const int* ftab;    // (T, P) factor table, entries in [0, r]
  float* mlp;         // (3, Pm): every MLP tensor, its mu and nu (kernels/ae_chunk.py mlp_layout)
  float* b;           // (3, K, m): B, mu, nu
  float* coef;        // (3, K): c ‖ c_trig, mu, nu
  float* omega;       // (3, 3r)
  float* svec;        // scheduler vector
  float* met;         // (num_steps, kMetrics)
  float* work;        // scratch, make_layout(...).total floats
  int n, m, P, T, K, num_steps, sched_every;
  float patience, factor, min_lr, beta, lam, ae_beta;
};

// Width of encoder activation e (0: X, 1..6 the hidden layers, 7 the latent).
__host__ __device__ inline int enc_width(int e, int m) {
  return e == 0 ? m : e == 1 ? 256 : e == 2 ? 128 : e == 3 ? 64 : e == 4 ? 16 : e == 5 ? 8 : e == 6 ? 4 : kR;
}

// Offsets of every MLP tensor in one generation, in the order of
// mlp_layout: ae_enc_w0, ae_enc_b0, ..., ae_enc_b6, ae_dec_w0, ..., ae_dec_b6.
// Layer l < 7 is encoder layer l, 7 + l decoder layer l; weights (in, out).
struct Mlp {
  long long w[2 * kL], b[2 * kL], total;
  int in[2 * kL], out[2 * kL];
};

__host__ __device__ inline Mlp make_mlp(int m) {
  Mlp M;
  long long o = 0;
  for (int l = 0; l < 2 * kL; ++l) {
    const int e = l < kL ? l : 2 * kL - l;  // decoder layer l - 7 maps width 7 - (l - 7) to 6 - (l - 7)
    M.in[l] = enc_width(e, m);
    M.out[l] = l < kL ? enc_width(e + 1, m) : enc_width(e - 1, m);
    M.w[l] = o;
    o += (long long)M.in[l] * M.out[l];
    M.b[l] = o;
    o += M.out[l];
  }
  M.total = o;
  return M;
}

// The column jobs: every product over the rows that the epoch needs, each
// an Lᵀ R (lt_r_tile) split over row groups, each (tile, group) task writing
// a partial that the next phase sums in group order. Phase 1 (gram, j <
// kGramJobs): D6ᵀX, D6ᵀD6, AᵀX, AᵀA and 1ᵀD6 (L a column of ones). Phase 2
// (weights): gW_l = inᵀ g_l for layers l < 13 (encoder 0..6, decoder 0..5),
// then the biases' 1ᵀ g_l (encoder 0..6, decoder 0..5). P x Q is the job's
// output.
__host__ __device__ inline void job_shape(int phase, int j, int m, int K, const Mlp& M, int* P, int* Q) {
  if (phase == 1) {
    const int Ps[kGramJobs] = {kH, kH, K, K, 1}, Qs[kGramJobs] = {m, kH, m, K, kH};
    *P = Ps[j];
    *Q = Qs[j];
  } else if (j < 2 * kL - 1) {
    *P = M.in[j];
    *Q = M.out[j];
  } else {
    *P = 1;
    *Q = M.out[j - (2 * kL - 1)];  // bias l = j - 13: encoder layers 0..6, then decoder layers 0..5 (7..12)
  }
}

__host__ __device__ inline int job_count(int phase) { return phase == 1 ? kGramJobs : kWeightJobs; }
__host__ __device__ inline int job_tiles(int P, int Q) { return ((P + kTP - 1) / kTP) * ((Q + kColTQ - 1) / kColTQ); }
// a job whose tiles keep every warp busy, split over several row groups
__host__ __device__ inline bool job_heavy(int P, int Q) { return P >= 64 && Q >= 64; }

// Row groups of a phase's jobs, heavy and light: the split of the G blocks
// in one round whose smaller count is largest (a task's time goes with its
// rows, about alike for both kinds), the heavy ones the more on a tie; at
// least 2 kColRows rows a group; one each where the tiles outnumber G.
struct JobGroups {
  int heavy, light;
};

__host__ __device__ inline JobGroups job_groups(int phase, int n, int m, int K, int G) {
  const Mlp M = make_mlp(m);
  int heavy = 0, light = 0;
  for (int j = 0; j < job_count(phase); ++j) {
    int P, Q;
    job_shape(phase, j, m, K, M, &P, &Q);
    (job_heavy(P, Q) ? heavy : light) += job_tiles(P, Q);
  }
  const int most = n / (2 * kColRows) > 1 ? n / (2 * kColRows) : 1;
  JobGroups best{1, 1};
  for (int gh = 1; gh <= most && heavy * gh + light <= G; ++gh) {
    int gl = light > 0 ? (G - heavy * gh) / light : gh;
    gl = gl < most ? gl : most;
    const int score = gh < gl ? gh : gl, best_score = best.heavy < best.light ? best.heavy : best.light;
    if (score >= best_score) best = JobGroups{gh, gl};
  }
  return best;
}

// Floats of a phase's partials: groups x P x Q per job, each job's rounded to 4.
__host__ __device__ inline long long job_part_floats(int phase, int n, int m, int K, int G) {
  const Mlp M = make_mlp(m);
  const JobGroups g = job_groups(phase, n, m, K, G);
  long long o = 0;
  for (int j = 0; j < job_count(phase); ++j) {
    int P, Q;
    job_shape(phase, j, m, K, M, &P, &Q);
    o += ((job_heavy(P, Q) ? g.heavy : g.light) * (long long)P * Q + 3) / 4 * 4;
  }
  return o;
}

// Offsets (in floats) into the scratch for a grid of G blocks, each a
// multiple of 4 (16-byte aligned). a[l] is the output of encoder layer l
// (a[6] the latent), d[l] the decoder's activation l (d[1..6]; d[0] is the
// latent), g[l] the gradient of encoder layer l's pre-activation and e[l]
// that of decoder activation l's. A (n, K) has row stride lda = K rounded up
// to 4 (zero beyond K); xp holds X with rows padded to mp = m rounded up to
// 4 floats (zero beyond m), copied at the launch's start, so that the column
// jobs stage it by 16-byte copies; jp1 and jp2 hold the column jobs'
// partials of phases 1 and 2.
struct Layout {
  long long a[kL], g[kL], d[kL], e[kL];
  long long A, dlp, sdd, sdx, sd, ax, ga, vv, cv, gb, part0, part2, sddvv, xp, jp1, jp2, timer, total;
  int nslab, lda, mp;
};

__host__ __device__ inline Layout make_layout(int n, int m, int K, int G) {
  Layout L;
  long long o = 0;
  auto take = [&](long long floats) {
    const long long at = o;
    o += (floats + 3) / 4 * 4;
    return at;
  };
  for (int l = 0; l < kL; ++l) {
    L.a[l] = take((long long)n * enc_width(l + 1, m));
    L.g[l] = take((long long)n * enc_width(l + 1, m));
  }
  L.d[0] = L.a[kL - 1];
  L.e[0] = -1;
  for (int l = 1; l < kL; ++l) {
    L.d[l] = take((long long)n * enc_width(kL - l, m));
    L.e[l] = take((long long)n * enc_width(kL - l, m));
  }
  L.nslab = (m + kSlab - 1) / kSlab;
  L.lda = (K + 3) / 4 * 4;
  L.mp = (m + 3) / 4 * 4;
  L.A = take((long long)n * L.lda);
  L.dlp = take((long long)n * kR);
  L.sdd = take((long long)kH * kH);
  L.sdx = take((long long)kH * m);
  L.sd = take(kH);
  L.ax = take((long long)K * m);
  L.ga = take(K * K);
  L.vv = take((long long)kH * kH);
  L.cv = take(kH);
  L.gb = take(K * K);
  L.part0 = take((long long)G * kPart0);
  L.part2 = take((long long)L.nslab * kPart2);
  L.sddvv = take(2);
  L.xp = take((long long)n * L.mp);
  L.jp1 = take(job_part_floats(1, n, m, K, G));
  L.jp2 = take(job_part_floats(2, n, m, K, G));
  L.timer = take(2 * kPhases);  // kPhases unsigned 64-bit ns counters
  L.total = o;
  return L;
}

// Shared floats: the staging of the products, then the row phases' and the
// column tasks' own.
constexpr int kLd = kMaxK + 1;
constexpr int kPersistFloats = kThreads /* red */ + kMaxK * kMaxP /* ftab */ + kMaxK /* c */ + 8 /* omega */ +
                               kMaxK * kMaxK /* gb */ + kMaxK /* cacc */ + 8 /* oacc */ + kRT * 4 /* aug */ +
                               4 * kRT * kLd /* D, V, A, Y */ + kRT * kR /* dl */ + 8 /* s1, s2 */ +
                               kMaxK * kSlab * 2 /* B slab, new */ + 4 * kSlab /* slab columns */;
// a column job: its operands, its output P x Q, its row groups, and where its
// partials (groups, P, Q) and its sums go (an offset into the scratch in
// phase 1, into the MLP tensors in phase 2)
struct ColJob {
  ColOperand l, r;
  int P, Q, groups, tiles;
  long long part, dst;
};
constexpr int kJobFloats = (int)((sizeof(ColJob) + 15) / 16 * 4);
constexpr int kJobsFloats = (kGramJobs + kWeightJobs) * kJobFloats;
// the Layout and the Mlp offsets live in shared memory, so that no thread
// carries them in registers through the launch
constexpr int kLayoutFloats = (int)((sizeof(Layout) + 15) / 16 * 4), kMlpFloats = (int)((sizeof(Mlp) + 15) / 16 * 4);
constexpr int kSmemFloats = kGemmFloats + kJobsFloats + kLayoutFloats + kMlpFloats + kPersistFloats;

#ifndef DESMO_EMULATED_GRID
__device__ __forceinline__ float* shared_base() {
  extern __shared__ float4 ae_smem4[];
  return reinterpret_cast<float*>(ae_smem4);
}

__device__ __forceinline__ unsigned long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#endif

// Block 0's thread 0 adds the time since its previous mark to a counter at
// each mark; a mark after a grid barrier takes in the wait for the slowest
// block.
struct PhaseClock {
  unsigned long long ns[kPhases] = {};
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
    for (int p = 0; p < kPhases; ++p) out[p] = ns[p];
  }
};

__device__ __forceinline__ float sgn(float v) { return (float)((v > 0.f) - (v < 0.f)); }
__device__ __forceinline__ float relu(float v) { return v > 0.f ? v : 0.f; }
// max that propagates NaN from either side, as torch.max does
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

// A strided matrix view: element (i, j) at p[i * sr + j * sc].
struct Mat {
  const float* p;
  long long sr, sc;
  __device__ float at(long long i, long long j) const { return p[i * sr + j * sc]; }
};

// The product of a row tile with a weight: acc(i, j) = sum_k A(i, k) W(k, j)
// for i < rows, j < nvalid <= 32 CT, passed to epi(i, j, acc). Chunks of kKC
// along k are staged in shared memory (A transposed, so a thread's 4 rows
// are one float4); thread (ty, tx) owns rows 4ty..4ty+3 and columns
// tx + 32c. Every thread of the block must call it.
template <int CT, typename Epi>
__device__ void row_gemm(Mat A, int rows, int kd, Mat W, int nvalid, float* smem, Epi epi) {
  constexpr int N = 32 * CT;
  float* As = smem;             // [kKC][kRT]
  float* Ws = smem + kKC * kRT;  // [kKC][N]
  const int t = threadIdx.x, tx = t % 32, ty = t / 32;
  float acc[4][CT];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[ii][c] = 0.f;
  for (int k0 = 0; k0 < kd; k0 += kKC) {
    __syncthreads();
    for (int e = t; e < kKC * kRT; e += kThreads) {
      const bool kfast = A.sc == 1;
      const int k = kfast ? e % kKC : e / kRT, i = kfast ? e / kKC : e % kRT;
      As[k * kRT + i] = (i < rows && k0 + k < kd) ? A.at(i, k0 + k) : 0.f;
    }
    for (int e = t; e < kKC * N; e += kThreads) {
      const bool jfast = W.sc == 1;
      const int j = jfast ? e % N : e / kKC, k = jfast ? e / N : e % kKC;
      Ws[k * N + j] = (j < nvalid && k0 + k < kd) ? W.at(k0 + k, j) : 0.f;
    }
    __syncthreads();
    const int kn = min(kKC, kd - k0);
    for (int k = 0; k < kn; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(As + k * kRT + 4 * ty);
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const float w = Ws[k * N + tx + 32 * c];
        acc[0][c] = fmaf(a.x, w, acc[0][c]);
        acc[1][c] = fmaf(a.y, w, acc[1][c]);
        acc[2][c] = fmaf(a.z, w, acc[2][c]);
        acc[3][c] = fmaf(a.w, w, acc[3][c]);
      }
    }
  }
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const int i = 4 * ty + ii, j = tx + 32 * c;
      if (i < rows && j < nvalid) epi(i, j, acc[ii][c]);
    }
}

// The same for the narrow layers (nout <= 16): one thread per output, the
// operands read where they lie. Every thread of the block must call it.
template <typename Epi>
__device__ void row_small(Mat A, int rows, int kd, Mat W, int nout, Epi epi) {
  __syncthreads();
  for (int o = threadIdx.x; o < rows * nout; o += kThreads) {
    const int i = o / nout, j = o % nout;
    float s = 0.f;
    for (int k = 0; k < kd; ++k) s = fmaf(A.at(i, k), W.at(k, j), s);
    epi(i, j, s);
  }
}

// One output tile of a column task: C(p, q) = sum over i < n of L(i, p)
// R(i, q) for p in [p0, p0 + kCP), q in [q0, q0 + kCQ), passed to
// epi(p, q, C) for p < P, q < Q. The rows are staged in chunks of kCR;
// thread (tp, tq) owns p0 + 2tp + {0, 1} and q0 + 4tq + {0..3}, and sums
// its outputs in row order. Every thread of the block must call it.
template <typename Epi>
__device__ void col_tile(Mat L, Mat R, int n, int P, int Q, int p0, int q0, float* smem, Epi epi) {
  float* Ls = smem;              // [kCR][kCP]
  float* Rs = smem + kCR * kCP;  // [kCR][kCQ]
  const int t = threadIdx.x, tp = t / 16, tq = t % 16;
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int i0 = 0; i0 < n; i0 += kCR) {
    __syncthreads();
    for (int e = t; e < kCR * kCP; e += kThreads) {
      const bool pfast = L.sc == 1;
      const int p = pfast ? e % kCP : e / kCR, i = pfast ? e / kCP : e % kCR;
      Ls[i * kCP + p] = (i0 + i < n && p0 + p < P) ? L.at(i0 + i, p0 + p) : 0.f;
    }
    for (int e = t; e < kCR * kCQ; e += kThreads) {
      const bool qfast = R.sc == 1;
      const int q = qfast ? e % kCQ : e / kCR, i = qfast ? e / kCQ : e % kCR;
      Rs[i * kCQ + q] = (i0 + i < n && q0 + q < Q) ? R.at(i0 + i, q0 + q) : 0.f;
    }
    __syncthreads();
    const int rn = min(kCR, n - i0);
    for (int i = 0; i < rn; ++i) {
      const float l0 = Ls[i * kCP + 2 * tp], l1 = Ls[i * kCP + 2 * tp + 1];
      const float4 r = *reinterpret_cast<const float4*>(Rs + i * kCQ + 4 * tq);
      acc[0][0] = fmaf(l0, r.x, acc[0][0]);
      acc[0][1] = fmaf(l0, r.y, acc[0][1]);
      acc[0][2] = fmaf(l0, r.z, acc[0][2]);
      acc[0][3] = fmaf(l0, r.w, acc[0][3]);
      acc[1][0] = fmaf(l1, r.x, acc[1][0]);
      acc[1][1] = fmaf(l1, r.y, acc[1][1]);
      acc[1][2] = fmaf(l1, r.z, acc[1][2]);
      acc[1][3] = fmaf(l1, r.w, acc[1][3]);
    }
  }
  for (int a = 0; a < 2; ++a)
    for (int c = 0; c < 4; ++c) {
      const int p = p0 + 2 * tp + a, q = q0 + 4 * tq + c;
      if (p < P && q < Q) epi(p, q, acc[a][c]);
    }
}

__host__ __device__ inline int tiles(int v, int w) { return (v + w - 1) / w; }

// Shared memory of a block: the staging of the products, then the row
// phases' persistent arrays.
struct Smem {
  float* gemm;  // kGemmFloats
  ColJob* jobs; // kGramJobs + kWeightJobs
  Layout* layout;
  Mlp* mlp;
  float* red;   // kThreads
  int* ft;      // (T, P) factor table
  float *c, *om, *gb, *cacc, *oacc;
  float *aug, *D, *V, *A, *Y, *dl, *s12;
  float *bslab, *bnew, *cols;
};

__device__ Smem carve(float* base) {
  Smem s;
  float* p = base;
  s.gemm = p; p += kGemmFloats;
  s.jobs = reinterpret_cast<ColJob*>(p); p += kJobsFloats;
  s.layout = reinterpret_cast<Layout*>(p); p += kLayoutFloats;
  s.mlp = reinterpret_cast<Mlp*>(p); p += kMlpFloats;
  s.red = p;  p += kThreads;
  s.ft = reinterpret_cast<int*>(p); p += kMaxK * kMaxP;
  s.c = p;    p += kMaxK;
  s.om = p;   p += 8;
  s.gb = p;   p += kMaxK * kMaxK;
  s.cacc = p; p += kMaxK;
  s.oacc = p; p += 8;
  s.aug = p;  p += kRT * 4;
  s.D = p;    p += kRT * kLd;
  s.V = p;    p += kRT * kLd;
  s.A = p;    p += kRT * kLd;
  s.Y = p;    p += kRT * kLd;
  s.dl = p;   p += kRT * kR;
  s.s12 = p;  p += 8;
  s.bslab = p; p += kMaxK * kSlab;
  s.bnew = p;  p += kMaxK * kSlab;
  s.cols = p;
  return s;
}

__device__ inline Mat rows_of(const float* base, long long r0, int width) {
  return Mat{base + r0 * width, width, 1};
}

// Phase 0 over the block's rows: both funnels forward, the dictionary and
// its gradients, and the decoder backward; per-block partials into part0.
__device__ void row_phase(const Args& a, const Layout& L, const Mlp& M, const Smem& s, PhaseClock& clock) {
  const int t = threadIdx.x, b = blockIdx.x, G = gridDim.x;
  const int n = a.n, m = a.m, K = a.K, T = a.T, P = a.P;
  float* w = a.work;
  const float* p = a.mlp;
  const float two_nm = (float)(2.0 / ((double)n * m));
  const float kae = (float)(2.0 * (double)a.ae_beta / ((double)n * m));
  for (int k = t; k < K; k += kThreads) { s.c[k] = a.coef[k]; s.cacc[k] = 0.f; }
  for (int q = t; q < 3 * kR; q += kThreads) { s.om[q] = a.omega[q]; s.oacc[q] = 0.f; }
  for (int e = t; e < K * K; e += kThreads) s.gb[e] = w[L.gb + e];
  float vmax = 0.f, s1 = 0.f, s2 = 0.f;
  const int Rw = (n + G - 1) / G, row_begin = b * Rw, row_end = min(n, row_begin + Rw);
  for (int r0 = row_begin; r0 < row_end; r0 += kRT) {
    const int rows = min(kRT, row_end - r0);
    // ---- encoder: a[l] = relu(a[l-1] W_l + b_l), no ReLU on the latent a[6]
    for (int l = 0; l < kL; ++l) {
      const Mat in = l == 0 ? rows_of(a.x, r0, m) : rows_of(w + L.a[l - 1], r0, M.in[l]);
      const Mat W{p + M.w[l], M.out[l], 1};
      const float* bias = p + M.b[l];
      float* out = w + L.a[l] + (long long)r0 * M.out[l];
      const int no = M.out[l];
      const bool last = l == kL - 1;
      auto epi = [&](int i, int j, float v) {
        v += bias[j];
        out[(long long)i * no + j] = last ? v : relu(v);
      };
      if (no == 256) row_gemm<8>(in, rows, M.in[l], W, no, s.gemm, epi);
      else if (no == 128) row_gemm<4>(in, rows, M.in[l], W, no, s.gemm, epi);
      else if (no == 64) row_gemm<2>(in, rows, M.in[l], W, no, s.gemm, epi);
      else row_small(in, rows, M.in[l], W, no, epi);
    }
    // ---- decoder: d[l+1] = relu(d[l] V_l + c_l) up to D6
    for (int l = 0; l < kL - 1; ++l) {
      const int gl = kL + l, no = M.out[gl];
      const Mat in = rows_of(w + L.d[l], r0, M.in[gl]);
      const Mat W{p + M.w[gl], no, 1};
      const float* bias = p + M.b[gl];
      float* out = w + L.d[l + 1] + (long long)r0 * no;
      auto epi = [&](int i, int j, float v) { out[(long long)i * no + j] = relu(v + bias[j]); };
      if (no == 256) row_gemm<8>(in, rows, M.in[gl], W, no, s.gemm, epi);
      else if (no == 128) row_gemm<4>(in, rows, M.in[gl], W, no, s.gemm, epi);
      else if (no == 64) row_gemm<2>(in, rows, M.in[gl], W, no, s.gemm, epi);
      else row_small(in, rows, M.in[gl], W, no, epi);
    }
    __syncthreads();
    clock.mark(kRowsForward);
    // ---- the dictionary on the latent: D, its trig derivative V, A = D c_eff
    const float* lat = w + L.a[kL - 1] + (long long)r0 * kR;
    for (int e = t; e < kRT * 3; e += kThreads) {
      const int i = e / 3, j = e % 3;
      s.aug[i * 4 + j] = i < rows ? (j == 0 ? 1.f : lat[i * kR + j - 1]) : 0.f;
    }
    if (t < rows) {
      const float l0 = lat[t * kR], l1 = lat[t * kR + 1];
      s1 = fmaf(l0, l0, s1);
      s2 = fmaf(l1, l1, s2);
    }
    __syncthreads();
    for (int e = t; e < kRT * K; e += kThreads) {
      const int i = e / K, k = e % K;
      float d = 0.f, v = 0.f, ce = 0.f;
      if (i < rows) {
        const float* ag = s.aug + i * 4;
        if (k < T) {
          d = ag[s.ft[k * P]];
          for (int q = 1; q < P; ++q) d *= ag[s.ft[k * P + q]];
          ce = s.c[k];
        } else {
          const int q = k - T, kind = q / kR, j = q % kR;
          const float arg = ag[1 + j] * s.om[q];
          vmax = max_nan(vmax, fabsf(arg));
          if (kind == 2) {
            d = tanhf(arg);
            v = 1.f - d * d;
          } else {
            float sn, cs;
            sincosf(arg, &sn, &cs);
            d = kind == 0 ? sn : cs;
            v = kind == 0 ? cs : -sn;
            ce = s.c[k];  // the tanh channel stays out of the sum
          }
        }
      }
      s.D[i * kLd + k] = d;
      s.V[i * kLd + k] = v;
      s.A[i * kLd + k] = d * ce;
      if (i < rows) w[L.A + (long long)(r0 + i) * L.lda + k] = d * ce;
    }
    for (int e = t; e < rows * (L.lda - K); e += kThreads)
      w[L.A + (long long)(r0 + e / (L.lda - K)) * L.lda + K + e % (L.lda - K)] = 0.f;
    // xb = X Bᵀ into Y
    row_gemm<1>(rows_of(a.x, r0, m), rows, m, Mat{a.b, 1, m}, K, s.gemm,
                [&](int i, int k, float v) { s.Y[i * kLd + k] = v; });
    __syncthreads();
    // dA = 2/nm (A gb - xb), in place of xb
    for (int e = t; e < rows * K; e += kThreads) {
      const int i = e / K, k = e % K;
      float sm = 0.f;
      for (int l = 0; l < K; ++l) sm = fmaf(s.A[i * kLd + l], s.gb[l * K + k], sm);
      s.Y[i * kLd + k] = two_nm * (sm - s.Y[i * kLd + k]);
    }
    __syncthreads();
    // coefficient and omega gradients: thread k owns column k
    for (int k = t; k < K; k += kThreads) {
      const bool trig = k >= T;
      const int q = k - T, j = q % kR;
      const float ce = (trig && q / kR == 2) ? 0.f : s.c[k];
      float gc = s.cacc[k], go = trig ? s.oacc[q] : 0.f;
      for (int i = 0; i < rows; ++i) {
        const float da = s.Y[i * kLd + k];
        gc = fmaf(da, s.D[i * kLd + k], gc);
        if (trig) go = fmaf(da * ce * s.V[i * kLd + k], s.aug[i * 4 + 1 + j], go);
      }
      s.cacc[k] = gc;
      if (trig) s.oacc[q] = go;
    }
    // the dictionary's latent gradient: the trig part through omega, the
    // polynomial part by the product rule over the P factors
    for (int e = t; e < rows * kR; e += kThreads) {
      const int i = e / kR, j = e % kR;
      const float* ag = s.aug + i * 4;
      float trig = 0.f;
      for (int kind = 0; kind < 2; ++kind) {  // tanh: c_eff = 0
        const int q = kind * kR + j, k = T + q;
        trig += s.Y[i * kLd + k] * s.c[k] * s.V[i * kLd + k] * s.om[q];
      }
      float poly = 0.f;
      for (int tt = 0; tt < T; ++tt)
        for (int q = 0; q < P; ++q) {
          if (s.ft[tt * P + q] != j + 1) continue;
          float prod = s.Y[i * kLd + tt] * s.c[tt];
          for (int u = 0; u < P; ++u)
            if (u != q) prod *= ag[s.ft[tt * P + u]];
          poly += prod;
        }
      s.dl[i * kR + j] = trig + poly;
    }
    __syncthreads();
    clock.mark(kRowsDictionary);
    // ---- the factored AE-MSE's dD6 = k (D6 VV + c6V6ᵀ - X V6ᵀ), times the ReLU mask
    const int h = kH;
    float* e6 = w + L.e[kL - 1] + (long long)r0 * h;
    const float* d6 = w + L.d[kL - 1] + (long long)r0 * h;
    const float* cv = w + L.cv;
    row_gemm<8>(rows_of(a.x, r0, m), rows, m, Mat{p + M.w[2 * kL - 1], 1, m}, h, s.gemm,
                [&](int i, int j, float v) { e6[i * h + j] = v; });
    row_gemm<8>(rows_of(d6, 0, h), rows, h, Mat{w + L.vv, h, 1}, h, s.gemm, [&](int i, int j, float v) {
      const float g = kae * (v + cv[j] - e6[i * h + j]);
      e6[i * h + j] = d6[i * h + j] > 0.f ? g : 0.f;
    });
    // ---- the decoder backward: e[l] = (e[l+1] V_lᵀ) * (d[l] > 0), to the latent
    for (int l = kL - 2; l >= 0; --l) {
      const int gl = kL + l, no = M.in[gl], ni = M.out[gl];
      const Mat in = rows_of(w + L.e[l + 1], r0, ni);
      const Mat Wt{p + M.w[gl], 1, ni};  // V_lᵀ
      if (l == 0) {
        auto epi = [&](int i, int j, float v) { w[L.dlp + (long long)(r0 + i) * kR + j] = s.dl[i * kR + j] + v; };
        row_small(in, rows, ni, Wt, no, epi);
        continue;
      }
      float* out = w + L.e[l] + (long long)r0 * no;
      const float* act = w + L.d[l] + (long long)r0 * no;
      auto epi = [&](int i, int j, float v) { out[i * no + j] = act[i * no + j] > 0.f ? v : 0.f; };
      if (no == 128) row_gemm<4>(in, rows, ni, Wt, no, s.gemm, epi);
      else if (no == 64) row_gemm<2>(in, rows, ni, Wt, no, s.gemm, epi);
      else row_small(in, rows, ni, Wt, no, epi);
    }
    __syncthreads();
    clock.mark(kRowsDecoder);
  }
  float* part = w + L.part0 + (long long)b * kPart0;
  const float bs1 = block_sum(s1, s.red), bs2 = block_sum(s2, s.red), bmax = block_max(vmax, s.red);
  if (t == 0) {
    part[0] = bs1;
    part[1] = bs2;
    part[2] = bmax;
  }
  for (int k = t; k < K; k += kThreads) part[3 + k] = s.cacc[k];
  for (int q = t; q < 3 * kR; q += kThreads) part[3 + kMaxK + q] = s.oacc[q];
}

// Phase 1, rows: the latent gradient gets the ortho term, then the encoder
// backward g[l-1] = (g[l] W_lᵀ) * (a[l-1] > 0) down to dpre1 = g[0].
__device__ void encoder_backward(const Args& a, const Layout& L, const Mlp& M, const Smem& s) {
  const int t = threadIdx.x, b = blockIdx.x, G = gridDim.x, n = a.n;
  float* w = a.work;
  float s1 = 0.f, s2 = 0.f;  // every block sums the partials in block order
  for (int bb = 0; bb < G; ++bb) {
    s1 += w[L.part0 + (long long)bb * kPart0];
    s2 += w[L.part0 + (long long)bb * kPart0 + 1];
  }
  const float korth = (float)(2.0 * (double)a.beta / ((double)n * n));
  const int Rw = (n + G - 1) / G, row_begin = b * Rw, row_end = min(n, row_begin + Rw);
  for (int r0 = row_begin; r0 < row_end; r0 += kRT) {
    const int rows = min(kRT, row_end - r0);
    __syncthreads();
    for (int e = t; e < rows * kR; e += kThreads) {
      const long long o = (long long)r0 * kR + e;
      const float lat = w[L.a[kL - 1] + o];
      w[L.g[kL - 1] + o] = w[L.dlp + o] + korth * ((e % kR == 0 ? s2 : s1) * lat);
    }
    for (int l = kL - 1; l >= 1; --l) {
      const int no = M.in[l], ni = M.out[l];
      const Mat in = rows_of(w + L.g[l], r0, ni);
      const Mat Wt{a.mlp + M.w[l], 1, ni};  // W_lᵀ
      float* out = w + L.g[l - 1] + (long long)r0 * no;
      const float* act = w + L.a[l - 1] + (long long)r0 * no;
      auto epi = [&](int i, int j, float v) { out[i * no + j] = act[i * no + j] > 0.f ? v : 0.f; };
      if (no == 256) row_gemm<8>(in, rows, ni, Wt, no, s.gemm, epi);
      else if (no == 128) row_gemm<4>(in, rows, ni, Wt, no, s.gemm, epi);
      else if (no == 64) row_gemm<2>(in, rows, ni, Wt, no, s.gemm, epi);
      else row_small(in, rows, ni, Wt, no, epi);
    }
  }
  __syncthreads();
}

// Job j of a task list of `jobs` entries with counts[j] tasks each: the
// task's job and its index within the job.
__device__ inline void which_job(int task, const int* counts, int jobs, int* job, int* idx) {
  int j = 0;
  while (j < jobs - 1 && task >= counts[j]) task -= counts[j++];
  *job = j;
  *idx = task;
}

// Builds both phases' column jobs into shared memory (thread 0; the caller
// syncs). Their operands lie in the scratch for the whole launch.
__device__ void build_jobs(const Args& a, const Layout& L, const Mlp& M, ColJob* jobs) {
  if (threadIdx.x != 0) return;
  const int n = a.n, m = a.m, K = a.K, G = gridDim.x;
  const float* w = a.work;
  const ColOperand X = col_operand(w + L.xp, L.mp, m), D6 = col_operand(w + L.d[kL - 1], kH, kH),
                   A = col_operand(w + L.A, L.lda, K), ones = col_operand(nullptr, 0, 1);
  for (int phase = 1; phase <= 2; ++phase) {
    const JobGroups g = job_groups(phase, n, m, K, G);
    long long part = phase == 1 ? L.jp1 : L.jp2;
    for (int j = 0; j < job_count(phase); ++j) {
      ColJob& J = jobs[phase == 1 ? j : kGramJobs + j];
      job_shape(phase, j, m, K, M, &J.P, &J.Q);
      J.groups = job_heavy(J.P, J.Q) ? g.heavy : g.light;
      J.tiles = job_tiles(J.P, J.Q);
      J.part = part;
      part += ((long long)J.groups * J.P * J.Q + 3) / 4 * 4;
      if (phase == 1) {
        const ColOperand ls[kGramJobs] = {D6, D6, A, A, ones}, rs[kGramJobs] = {X, D6, X, A, D6};
        const long long dst[kGramJobs] = {L.sdx, L.sdd, L.ax, L.ga, L.sd};
        J.l = ls[j];
        J.r = rs[j];
        J.dst = dst[j];
      } else if (j < 2 * kL - 1) {
        // gW_l = inᵀ · g: in the layer's input activation, g its pre-activation gradient
        const int l = j, dl = l - kL;
        J.l = l == 0 ? X : col_operand(w + (l < kL ? L.a[l - 1] : L.d[dl]), J.P, J.P);
        J.r = col_operand(w + (l < kL ? L.g[l] : L.e[dl + 1]), J.Q, J.Q);
        J.dst = M.w[l];
      } else {
        const int l = j - (2 * kL - 1);
        J.l = ones;
        J.r = col_operand(w + (l < kL ? L.g[l] : L.e[l - kL + 1]), J.Q, J.Q);
        J.dst = M.b[l];
      }
    }
  }
}

// Tasks of a list of nj column jobs: (job, group, tile) in that order.
__device__ inline int job_task_count(const ColJob* jobs, int nj) {
  int total = 0;
  for (int j = 0; j < nj; ++j) total += jobs[j].tiles * jobs[j].groups;
  return total;
}

// Task `task` of a job list: the partial of one output tile over one row
// group, into the job's partials. Every thread of the block must call it.
__device__ void job_task(const ColJob* jobs, int n, float* w, float* ring, int task) {
  int j = 0;
  while (task >= jobs[j].tiles * jobs[j].groups) {
    task -= jobs[j].tiles * jobs[j].groups;
    ++j;
  }
  const ColJob& J = jobs[j];
  const int grp = task / J.tiles, tile = task % J.tiles, qt = (J.Q + kColTQ - 1) / kColTQ;
  const int p0 = (tile / qt) * kTP, q0 = (tile % qt) * kColTQ;
  const int rg = (n + J.groups - 1) / J.groups, i0 = min(n, grp * rg), i1 = min(n, i0 + rg);
  lt_r_tile<kTP>(J.l, J.r, i0, i1, p0, q0, ring, w + J.part + (long long)grp * J.P * J.Q + (long long)p0 * J.Q + q0,
                 J.Q);
}

// Sum task `task` of `count` over a job list: its share of the outputs'
// entries (in job order), each the sum of its job's partials in group
// order, passed to epi(job, entry, value), entry = p Q + q.
template <typename Epi>
__device__ void job_sums(const ColJob* jobs, int nj, const float* w, int task, int count, Epi epi) {
  long long total = 0;
  for (int j = 0; j < nj; ++j) total += (long long)jobs[j].P * jobs[j].Q;
  const long long chunk = (total + count - 1) / count, e0 = task * chunk, e1 = e0 + chunk < total ? e0 + chunk : total;
  long long base = 0;
  for (int j = 0; j < nj && base < e1; ++j) {
    const ColJob& J = jobs[j];
    const long long ej = (long long)J.P * J.Q, lo = e0 > base ? e0 : base, hi = e1 < base + ej ? e1 : base + ej;
    for (long long e = lo + threadIdx.x; e < hi; e += kThreads) {
      const float* part = w + J.part + (e - base);
      float v = 0.f;
      for (int g = 0; g < J.groups; ++g) v += part[g * ej];
      epi(J, e - base, v);
    }
    base += ej;
  }
}

// Sum tasks that go with `tasks` tile tasks in a phase of `blocks` blocks:
// the blocks the tile tasks leave idle, or one round of all blocks.
__device__ inline int sum_task_count(int tasks, int blocks) { return tasks < blocks ? blocks - tasks : blocks; }

// Phase 1, columns: the tasks of the gram jobs (D6ᵀX, D6ᵀD6, AᵀX, AᵀA, 1ᵀD6).
__device__ void gram_tasks(const Args& a, const Smem& s) {
  const int total = job_task_count(s.jobs, kGramJobs);
  for (int task = blockIdx.x; task < total; task += gridDim.x) job_task(s.jobs, a.n, a.work, s.gemm, task);
}

// Phase 2, columns: the tasks of the weight jobs (every MLP weight and bias
// gradient but V6's and c6's), then the sums of the gram jobs' partials
// into S_dX, S_dd, ax, ga and s_d, over the blocks the tasks leave idle.
__device__ void weight_tasks(const Args& a, const Smem& s) {
  const ColJob* wj = s.jobs + kGramJobs;
  const int tasks = job_task_count(wj, kWeightJobs), sums = sum_task_count(tasks, gridDim.x);
  float* w = a.work;
  for (int task = blockIdx.x; task < tasks + sums; task += gridDim.x) {
    if (task < tasks) {
      job_task(wj, a.n, w, s.gemm, task);
    } else {
      job_sums(s.jobs, kGramJobs, w, task - tasks, sums, [&](const ColJob& J, long long e, float v) { w[J.dst + e] = v; });
    }
  }
}

// Phase 3: the sums of the weight jobs' partials, each with its Adamax step
// (lr_z and the bias read before this epoch's scheduler step), over the
// tasks that follow the next epoch's (next_epoch_tasks) on the blocks
// first, first + stride, ...
__device__ void weight_steps(const Args& a, const Mlp& M, const Smem& s, int first, int stride, int before, float lr,
                             float bias) {
  const int sums = sum_task_count(before, stride);
  float* p = a.mlp;
  const long long Pm = M.total;
  for (int task = first; task < before + sums; task += stride) {
    if (task < before) continue;
    job_sums(s.jobs + kGramJobs, kWeightJobs, a.work, task - before, sums, [&](const ColJob& J, long long e, float v) {
      const long long o = J.dst + e;
      adamax(p + o, p + Pm + o, p + 2 * Pm + o, v, lr, bias);
    });
  }
}

// Phase 2, slabs of kSlab columns of m: V6 (dV6 = k (S_dd V6 + s_dᵀ c6 -
// S_dX)), c6 (dc6 = k (s_d V6 + n c6 - xcol)) and B (gB = 2/nm (ga B - ax))
// from the pre-update values, their Adamax steps, and the slab's partials of
// the metrics.
__device__ void slab_tasks(const Args& a, const Layout& L, const Mlp& M, const Smem& s) {
  const int t = threadIdx.x, n = a.n, m = a.m, K = a.K;
  float* w = a.work;
  float* V6 = a.mlp + M.w[2 * kL - 1];
  float* c6 = a.mlp + M.b[2 * kL - 1];
  const long long Pm = M.total, km = (long long)K * m;
  const float lr = a.svec[kLr0 + kLrZ], bias = 1.f - a.svec[kPow] * kB1;
  const float two_nm = (float)(2.0 / ((double)n * m));
  const float kae = (float)(2.0 * (double)a.ae_beta / ((double)n * m));
  float* Vs = s.gemm;            // (kH, kSlab)
  float* cc = s.cols;            // c6 of the slab
  float* xc = s.cols + kSlab;    // xcol of the slab
  float* sv = s.cols + 2 * kSlab;  // s_d V6 of the slab
  for (int sl = blockIdx.x; sl <= L.nslab; sl += gridDim.x) {
    if (sl == L.nslab) {  // the last task: <S_dd, VV> and <ga, gb> for the metrics
      float v = 0.f;
      for (int e = t; e < kH * kH; e += kThreads) v = fmaf(w[L.sdd + e], w[L.vv + e], v);
      v = block_sum(v, s.red);
      if (t == 0) {
        float u = 0.f;
        for (int e = 0; e < K * K; ++e) u = fmaf(w[L.ga + e], w[L.gb + e], u);
        w[L.sddvv] = v;
        w[L.sddvv + 1] = u;
      }
      continue;
    }
    const int j0 = sl * kSlab, wd = min(kSlab, m - j0);
    __syncthreads();
    for (int e = t; e < kH * kSlab; e += kThreads) {
      const int q = e / kSlab, jj = e % kSlab;
      Vs[e] = jj < wd ? V6[(long long)q * m + j0 + jj] : 0.f;
    }
    for (int e = t; e < K * kSlab; e += kThreads) {
      const int k = e / kSlab, jj = e % kSlab;
      s.bslab[e] = jj < wd ? a.b[(long long)k * m + j0 + jj] : 0.f;
    }
    if (t < kSlab) {
      cc[t] = t < wd ? c6[j0 + t] : 0.f;
      xc[t] = t < wd ? a.xcol[j0 + t] : 0.f;
    }
    __syncthreads();
    // thread t owns row t of V6's slab
    float acc[kSlab];
#pragma unroll
    for (int jj = 0; jj < kSlab; ++jj) acc[jj] = 0.f;
    for (int q = 0; q < kH; ++q) {
      const float sq = w[L.sdd + (long long)q * kH + t];  // S_dd is symmetric
#pragma unroll
      for (int jj = 0; jj < kSlab; ++jj) acc[jj] = fmaf(sq, Vs[q * kSlab + jj], acc[jj]);
    }
    const float sd = w[L.sd + t];
    float cross = 0.f;
    for (int jj = 0; jj < wd; ++jj) {
      const float sdx = w[L.sdx + (long long)t * m + j0 + jj];
      cross = fmaf(sdx, Vs[t * kSlab + jj], cross);
      acc[jj] = kae * (acc[jj] + sd * cc[jj] - sdx);
    }
    if (t < kSlab) {
      float v = 0.f;
      for (int q = 0; q < kH; ++q) v = fmaf(w[L.sd + q], Vs[q * kSlab + t], v);
      sv[t] = v;
    }
    for (int e = t; e < K * kSlab; e += kThreads) {
      const int k = e / kSlab, jj = e % kSlab;
      float g = 0.f;
      if (jj < wd) {
        float sm = 0.f;
        for (int l = 0; l < K; ++l) sm = fmaf(w[L.ga + k * K + l], s.bslab[l * kSlab + jj], sm);
        g = two_nm * (sm - w[L.ax + (long long)k * m + j0 + jj]);
      }
      s.bnew[e] = g;
    }
    cross = block_sum(cross, s.red);  // its barriers order the reads above before the updates below
    if (t == 0) {
      float sdv6_c6 = 0.f, xcol_c6 = 0.f, c6c6 = 0.f, axb = 0.f;
      for (int jj = 0; jj < wd; ++jj) {
        sdv6_c6 = fmaf(sv[jj], cc[jj], sdv6_c6);
        xcol_c6 = fmaf(xc[jj], cc[jj], xcol_c6);
        c6c6 = fmaf(cc[jj], cc[jj], c6c6);
      }
      for (int k = 0; k < K; ++k)
        for (int jj = 0; jj < wd; ++jj)
          axb = fmaf(w[L.ax + (long long)k * m + j0 + jj], s.bslab[k * kSlab + jj], axb);
      float* part = w + L.part2 + (long long)sl * kPart2;
      part[0] = cross;
      part[1] = sdv6_c6;
      part[2] = xcol_c6;
      part[3] = c6c6;
      part[4] = axb;
    }
    for (int jj = 0; jj < wd; ++jj) {
      const long long o = M.w[2 * kL - 1] + (long long)t * m + j0 + jj;
      adamax(a.mlp + o, a.mlp + Pm + o, a.mlp + 2 * Pm + o, acc[jj], lr, bias);
    }
    if (t < wd) {
      const long long o = M.b[2 * kL - 1] + j0 + t;
      const float g = kae * (sv[t] + (float)n * cc[t] - xc[t]);
      adamax(a.mlp + o, a.mlp + Pm + o, a.mlp + 2 * Pm + o, g, lr, bias);
    }
    for (int e = t; e < K * kSlab; e += kThreads) {
      const int k = e / kSlab, jj = e % kSlab;
      if (jj < wd) {
        const long long o = (long long)k * m + j0 + jj;
        adamax(a.b + o, a.b + km + o, a.b + 2 * km + o, s.bnew[e], lr, bias);
      }
    }
  }
}

// Phase 3 and the prologue: VV = V6V6ᵀ, cV = V6 c6 and gb = B Bᵀ of the
// parameters as they stand, over blocks first, first + stride, ...
__device__ void next_epoch_tasks(const Args& a, const Layout& L, const Mlp& M, const Smem& s, int first, int stride) {
  const int t = threadIdx.x, m = a.m, K = a.K;
  float* w = a.work;
  const float* V6 = a.mlp + M.w[2 * kL - 1];
  const float* c6 = a.mlp + M.b[2 * kL - 1];
  const Mat V6t{V6, 1, m}, Bt{a.b, 1, m};
  const int counts[3] = {tiles(kH, kCP) * tiles(kH, kCQ), 1, 1};
  for (int task = first; task < counts[0] + 2; task += stride) {
    int job, i;
    which_job(task, counts, 3, &job, &i);
    if (job == 0) {
      const int qt = tiles(kH, kCQ);
      col_tile(V6t, V6t, m, kH, kH, (i / qt) * kCP, (i % qt) * kCQ, s.gemm,
               [&](int p, int q, float v) { w[L.vv + (long long)p * kH + q] = v; });
    } else if (job == 1) {
      col_tile(Bt, Bt, m, K, K, 0, 0, s.gemm, [&](int p, int q, float v) { w[L.gb + p * K + q] = v; });
    } else {
      // cV[p] = sum_j V6[p][j] c6[j]: warp per row, lanes strided over j, the
      // 32 lane sums added in lane order
      const int lane = t % 32, warp = t / 32;
      for (int p0 = 0; p0 < kH; p0 += kThreads / 32) {
        const int p = p0 + warp;
        float v = 0.f;
        for (int j = lane; j < m; j += 32) v = fmaf(V6[(long long)p * m + j], c6[j], v);
        __syncthreads();
        s.red[t] = v;
        __syncthreads();
        if (lane == 0) {
          float u = 0.f;
          for (int l = 0; l < 32; ++l) u += s.red[t + l];
          w[L.cv + p] = u;
        }
      }
    }
  }
}

// Phase 3, block 0: the metrics row of the pre-update parameters, the
// coefficient and omega Adamax and the plateau scheduler.
__device__ void finalize(const Args& a, const Layout& L, const Smem& s, int step) {
  const int t = threadIdx.x, G = gridDim.x, n = a.n, K = a.K, T = a.T;
  float* w = a.work;
  float* sv = a.svec;
  float* f = s.Y;  // kPart0 reduced partials, then the 5 slab sums
  const float powb = sv[kPow] * kB1, bias = 1.f - powb;
  if (t < kPart0) {
    float v = 0.f;
    for (int bb = 0; bb < G; ++bb) {
      const float u = w[L.part0 + (long long)bb * kPart0 + t];
      v = t == 2 ? max_nan(v, u) : v + u;
    }
    f[t] = v;
  } else if (t < kPart0 + 5) {
    float v = 0.f;
    for (int sl = 0; sl < L.nslab; ++sl) v += w[L.part2 + (long long)sl * kPart2 + t - kPart0];
    f[t] = v;
  }
  __syncthreads();
  if (t == 0) {
    const float nm = (float)((double)n * a.m), x_sq = *a.x_sq;
    const float rec = (w[L.sddvv + 1] - 2.f * f[kPart0 + 4] + x_sq) / nm;
    const float ortho = f[0] * f[1] / (float)((double)n * n);
    float l1 = 0.f;
    for (int k = 0; k < K - kR; ++k) l1 += fabsf(a.coef[k]);  // the tanh lanes are the last r
    const float ae = (w[L.sddvv] - 2.f * f[kPart0] + 2.f * f[kPart0 + 1] - 2.f * f[kPart0 + 2] +
                      (float)n * f[kPart0 + 3] + x_sq) / nm;
    const float total = rec + a.beta * ortho + a.lam * l1 + a.ae_beta * ae;
    float* row = a.met + (long long)step * kMetrics;
    row[0] = rec;
    row[1] = ortho;
    row[2] = l1;
    row[3] = total;
    row[4] = f[2];
    row[5] = ae;
    s.s12[0] = total;
  }
  __syncthreads();
  if (t < K) {
    const bool on = t < K - kR;  // the tanh lanes: zero gradient and zero L1
    const float g = on ? f[3 + t] + a.lam * sgn(a.coef[t]) : 0.f;
    adamax(a.coef + t, a.coef + K + t, a.coef + 2 * K + t, g, sv[kLr0 + kLrCoef], bias);
  } else if (t >= 64 && t < 64 + 3 * kR) {
    const int q = t - 64;
    adamax(a.omega + q, a.omega + 3 * kR + q, a.omega + 6 * kR + q, f[3 + kMaxK + q], sv[kLr0 + kLrOmega], bias);
  }
  __syncthreads();
  if (t == 0) {
    const float total = s.s12[0];
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
  (void)T;
}

__global__ void __launch_bounds__(kThreads, 1) ae_chunk_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  const int b = blockIdx.x, G = gridDim.x;
  PhaseClock clock;
  const Smem s = carve(shared_base());
  if (threadIdx.x == 0) {
    *s.layout = make_layout(a.n, a.m, a.K, G);
    *s.mlp = make_mlp(a.m);
  }
  __syncthreads();
  const Layout& L = *s.layout;
  const Mlp& M = *s.mlp;
  for (int e = threadIdx.x; e < a.T * a.P; e += kThreads) s.ft[e] = a.ftab[e];
  build_jobs(a, L, M, s.jobs);
  // X with rows padded to mp floats, zero beyond m, for the column jobs' 16-byte copies
  for (long long e = (long long)b * kThreads + threadIdx.x; e < (long long)a.n * L.mp; e += (long long)G * kThreads) {
    const long long i = e / L.mp, j = e % L.mp;
    a.work[L.xp + e] = j < a.m ? a.x[i * a.m + j] : 0.f;
  }
  __syncthreads();
  next_epoch_tasks(a, L, M, s, b, G);
  grid.sync();
  clock.mark(kPrologue);
  // tasks of next_epoch_tasks: VV's tiles, gb and cV
  const int next_tasks = tiles(kH, kCP) * tiles(kH, kCQ) + 2;
  for (int step = 0; step < a.num_steps; ++step) {
    // the MLP's LR and Adamax bias before this epoch's scheduler step (finalize)
    const float lr_z = a.svec[kLr0 + kLrZ], bias_z = 1.f - a.svec[kPow] * kB1;
    row_phase(a, L, M, s, clock);
    grid.sync();
    clock.mark(kRowsBarrier);
    encoder_backward(a, L, M, s);
    clock.mark(kEncBackward);
    gram_tasks(a, s);
    clock.mark(kEncColumns);
    grid.sync();
    clock.mark(kEncBarrier);
    weight_tasks(a, s);
    clock.mark(kColWeights);
    grid.sync();
    clock.mark(kColWeightsBarrier);
    slab_tasks(a, L, M, s);
    clock.mark(kColV6);
    grid.sync();
    clock.mark(kColBarrier);
    if (b == 0) finalize(a, L, s, step);
    if (G == 1 || b > 0) {
      const int first = G == 1 ? 0 : b - 1, stride = G == 1 ? 1 : G - 1;
      if (G == 1) __syncthreads();
      next_epoch_tasks(a, L, M, s, first, stride);
      weight_steps(a, M, s, first, stride, next_tasks, lr_z, bias_z);
    }
    grid.sync();
    clock.mark(kFinalize);
  }
  clock.store(a.work + L.timer);
}

size_t smem_bytes() { return sizeof(float) * (size_t)kSmemFloats; }

bool valid_shape(int n, int m, int P, int T) {
  return n >= 1 && m >= 1 && P >= 1 && P <= kMaxP && T >= 1 && T + 3 * kR <= kMaxK;
}

}  // namespace

extern "C" {

// Blocks of the cooperative launch on the current device (one per SM), or a
// negative cudaError_t: cooperative launch unsupported, or no block fits.
int ae_chunk_grid() {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return -(int)err;
  if (!coop) return -(int)cudaErrorNotSupported;
  const void* kernel = (const void*)ae_chunk_kernel;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes());
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem_bytes());
  if (err != cudaSuccess) return -(int)err;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  return sms;
}

// Floats of scratch the launch needs for a grid of `grid` blocks; K = T + 3r.
long long ae_chunk_workspace(int n, int m, int K, int grid) { return make_layout(n, m, K, grid).total; }

// Offset (in floats) in the scratch of the launch's kPhases 64-bit
// nanosecond counters (enum Phase), summed over the epochs.
long long ae_chunk_timer_offset(int n, int m, int K, int grid) { return make_layout(n, m, K, grid).timer; }

// Runs num_steps epochs in place on mlp, b, coef, omega and svec; writes
// the metrics rows. ftab is the (T, P) factor table. Returns a cudaError_t.
int ae_train_chunk(const float* x, const float* x_sq, const float* xcol, const int* ftab, float* mlp, float* b,
                   float* coef, float* omega, float* svec, float* met, float* work, int n, int m, int P, int T,
                   int num_steps, int sched_every, int grid, float patience, float factor, float min_lr,
                   float beta, float lam, float ae_beta, void* stream) {
  if (!valid_shape(n, m, P, T) || num_steps < 1 || sched_every < 1 || grid < 1 || !x || !ftab || !work)
    return (int)cudaErrorInvalidValue;
  Args args{x, x_sq, xcol, ftab, mlp, b, coef, omega, svec, met, work,
            n, m, P, T, T + 3 * kR, num_steps, sched_every, patience, factor, min_lr, beta, lam, ae_beta};
  const void* kernel = (const void*)ae_chunk_kernel;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes());
  if (err != cudaSuccess) return (int)err;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), params, smem_bytes(),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
