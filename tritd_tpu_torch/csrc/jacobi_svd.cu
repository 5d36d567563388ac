// The thin SVD (u, s, vh) of a real p x q matrix by blocked one-sided
// (Hestenes) Jacobi, for ops/device_linalg.py::jacobi_svd.
//
// It replaces no Pallas kernel. It stands for `jnp.linalg.svd` inside the
// reference's `fori_loop`s (the SVT's "svd" route, tritd_tpu/ops/svt.py:143,
// under tritd_tpu/baselines/{ttnn,rtrc,rc_fctn,trpca}.py), which XLA lowers
// to a library call that checks nothing on the host. No cuSOLVER SVD driver
// can be captured in a CUDA graph: gesvdj, Xgesvd and Xgesvdp read back to
// the host inside the call (`python -m tritd_tpu_torch.tools.capture_linalg`).
// This one reads nothing back: a call is five launches that a graph holds,
// and its sweeps run in one of them until a sweep rotates nothing.
//
// What it computes, as torch.linalg.svd(a, full_matrices=False): k = min(p,
// q), s descending (ties in index order, NaN first, as torch's stable sort),
// u (p, k), vh (k, q). It works on the tall form W (m x k, m >= k): the input,
// or its transpose, held as Wt (its k columns as rows of length ldw, zero
// padded to whole tiles and to nb blocks of kBlock rows) beside Vt (the
// columns of V as rows, V = I at the start). At the end s_j = ||W e_j||
// (0 where it is negligible: below `negligible` s_max), the normalized rows
// of Wt (zero where s_j = 0) and the rows of Vt, sorted by s, are W's U^T
// and V^T: for a tall input u = wn^T, vh = vs; for a wide one u = vs^T, vh =
// wn.
//
// A sweep pairs the nb blocks by a round-robin tournament (nb - 1 rounds of
// nb / 2 disjoint pairs; a zero block makes nb even). All sweeps run in one
// persistent launch, `sweep_kernel`: a team of clusters of CTAs a pair (one
// cluster takes several pairs a round where the card holds fewer clusters
// than pairs), each CTA one slice of Wt's columns (and of Vt's), every CTA
// of the grid resident at once (the host plans the grid from
// cudaOccupancyMaxActiveClusters), a grid-wide barrier between two rounds.
// A CTA's visit of a pair:
//   1. its slice of the pair's 32 rows of Wt into shared memory by bulk
//      copies (cp.async.bulk, one a row, behind an mbarrier): the whole
//      slice where it fits ("resident": W read and written once a round),
//      else chunks through a ring of stages (the update takes the last
//      ones from the stages and copies the others again);
//   2. its partial 32 x 32 Gram X X^T: float32 on the FFMA pipe (TF32 would
//      lose float32's rotation test), float64 on the tensor cores
//      (mma.sync m8n8k4 f64, DMMA); stored in its shared memory;
//   3. a cluster barrier, then every CTA sums the cluster's partials through
//      distributed shared memory, in rank (slice) order, in double; in a
//      team of several clusters each cluster's sum goes through global
//      memory (a count a pair, then the sums in member order): every CTA
//      holds the same Gram, bit for bit, and runs the same inner pass (no
//      broadcast of R);
//   4. a cyclic Jacobi pass over the 32 x 32 Gram in shared memory, in
//      double, rounds of 16 disjoint rotations: at a sweep's first round
//      every pair of the 32 (the same tournament, 31 rounds), at the others
//      the 256 pairs across the two blocks (16 rounds), so that a sweep
//      rotates each pair of columns once; each rotation only where |g_pq| >
//      tol sqrt(g_pp) sqrt(g_qq) (tol = sqrt(k) eps of the input's dtype:
//      LAPACK gesvj's sqrt(m) eps let float32 values at the video cut's m =
//      96000 stop 1e-5 s_max off; ops/device_linalg.py::jacobi_tol) and
//      both g_pp and g_qq exceed `rounding` =
//      (4 eps)^2 times the reference, the largest Gram diagonal so far (the
//      pair's own and the largest that the previous round's pairs left in
//      `refs`, each its own reference), accumulating R = J_31 ... J_1;
//   5. where it rotated, X <- R X (R rounded to the input's dtype) on its
//      slice of W's and V's rows, written back (float64's W on DMMA), and
//      the sweep's flag set.
// After a sweep's last round every CTA reads the sweep's flag: a sweep
// without a rotation ends the launch, else the next one starts, up to the
// cap `sweeps` (<= kSweeps). A call that stopped at the cap still rotating
// adds one to `capped`, a count on the device that the caller keeps across
// calls (ops/device_linalg.py::jacobi_capped); its sweeps and whether it
// converged stay in `state` for the caller to read.
//
// Design, and what bounds it. The flops of a round are those of two GEMMs of
// the tall matrix, 64 m k each (the Gram and the update; V adds 64 k^2),
// over about 8 - 14 sweeps of nb - 1 rounds at the taxi cuts (up to 40 on a
// graded spectrum). A round moves W (20 MB at the taxi cuts in float32)
// through the L2 and device memory: the Gram and the update took most of a
// round (tools/jacobi_phases), then the inner pass (16 - 31 rounds of two
// barriers) and the barriers; the arithmetic is a fraction. Against that:
//   * one launch for all sweeps: no launch gaps between rounds, and the
//     sweeps after convergence cost nothing; the partial Grams and R stay in
//     shared memory (only a team's cluster sums go through global memory);
//   * W's traffic (read for the Gram, read again and written for the
//     update) ran slower on 64 - 96 CTAs of 132 SMs. So the plan takes as many CTAs
//     as the card holds (about one an SM): clusters of up to 16 CTAs (the
//     non-portable size, any size the card holds one a pair), and teams of
//     up to 8 clusters a pair where the card holds fewer large clusters
//     than pairs (30 of 4 against taxi's 32 pairs); slices small enough to
//     stay resident read W once a round; a ring of three stages where
//     chunks of 5 tiles fit (float32), of two else;
//   * blocks of 16 columns (pairs of 32 rows) give nb / 2 pairs a round; 4
//     groups of 64 threads split each tile of 64 columns of a float32 Gram,
//     8 warps the 4-column steps of a float64 one;
//   * one inner pass a visit of a pair (no inner convergence), and after a
//     sweep's first round only across the two blocks;
//   * the inner problem in double for a float32 input: in float32 the
//     accumulated rotations left V orthogonal to 1.5e-4 at 2000 x 200, in
//     double to 6e-7;
//   * no preconditioning QR: torch.linalg.qr of a 4800 x 512 matrix took 5.0
//     ms on the H100;
//   * a pair that did not rotate skips its update;
//   * the floor of the test. X <- R X leaves rounding of about eps times a
//     large column in every column it mixes with it; on an exactly
//     rank-deficient matrix (a static clip's unfolding: one column
//     repeated) such columns are all that is left beside the large ones.
//     Without the floor they rotated against each other in every sweep,
//     each rotation's rounding making new noise, down to underflow (where a
//     zero diagonal beside a nonzero product passed the test), and the call
//     stopped at the cap. Under the floor they are left as they are, and
//     their singular values, at most 4 eps s_max, are returned as 0, their
//     U columns zero (`negligible`, 8 eps: every column kept was tested
//     against every other kept one in the last sweep). The floor costs
//     accuracy (a value up to about 3 times it can be spread over columns
//     each under it), so it is as low as the exact families allow with a
//     margin (ops/device_linalg.py::JACOBI_ROUNDING). The reference is the
//     largest diagonal so far, not the pair's own: a pair of two blocks of
//     such noise holds nothing larger, and rotated its noise in every sweep.
// The bound the smoke holds it to is that of an SVD, not of these sweeps.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 16;         // columns of W a block holds
constexpr int kPair = 2 * kBlock;  // rows of a pair
constexpr int kTile = 64;          // columns of Wt a slice is cut in (ldw is a multiple)
constexpr int kSweeps = 48;        // the cap; ops/device_linalg.py's JACOBI_SWEEPS
constexpr int kThreads = 256;      // a CTA: kBlock^2 threads for the inner pass, 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = kThreads / 64;  // float32 Gram: groups of 64 threads, 16 columns of a tile each
constexpr int kMaxPairs = 32;           // nb / 2 at the largest thin side, 1024
constexpr int kMaxTeam = 8;             // clusters a pair
constexpr int kRing = 3;                // the most stages of a slice that does not stay resident
constexpr int kPad = 4;                 // elements past a staged row (its 16-byte bank groups spread)
constexpr int kMaxCluster = 16;
constexpr int kSmemLimit = 232448;      // a CTA's shared memory on the H100
constexpr int kNormThreads = 256;

// state: whether the call converged, the sweeps it ran, the grid barrier's
// arrivals, then one flag a sweep (whether it rotated), then one count a
// pair of the round (its team's clusters' arrivals)
enum { kConverged = 0, kSweepsRun = 1, kArrived = 2, kStateHead = 4 };

// Round `round` of the round-robin tournament of n players (n even): its
// i-th pair of n / 2. ops/device_linalg.py::jacobi_tournament is the same.
__device__ __forceinline__ int2 tournament_pair(int n, int round, int i) {
  const int a = i == 0 ? 0 : 1 + (i - 1 + round) % (n - 1);
  const int b = 1 + (n - 2 - i + round) % (n - 1);
  return make_int2(a, b);
}

// Pair x of inner round r of a pair's sweep: at an outer sweep's first round
// the tournament of the 2 kBlock indices (31 rounds), at the others the
// pairs across the two blocks (kBlock rounds): a sweep rotates each pair of
// columns once. ops/device_linalg.py::jacobi_inner_rounds is the same.
__device__ __forceinline__ int2 inner_pair(bool first, int r, int x) {
  return first ? tournament_pair(kPair, r, x) : make_int2(x, kBlock + (x + r) % kBlock);
}

// Row of Wt (or Vt) that is row i of the pair of blocks ab.
__device__ __forceinline__ int64_t pair_row(int2 ab, int i) {
  return static_cast<int64_t>(i < kBlock ? ab.x : ab.y) * kBlock + (i % kBlock);
}

// What a CTA of sweep_kernel keeps in shared memory besides its stages of
// Wt (after it, from kFixed<T>); sizes in ops/device_linalg.py's
// JACOBI_FIXED_SMEM.
template <typename T>
struct Shared {
  unsigned long long bar[kRing];  // a stage's mbarrier
  T part[2][kPair][kPair];    // this CTA's partial Gram, by the parity of its visits; the cluster reads it
  T rt[kPair][kPair];         // R in T, which the update applies
  union {
    struct {
      double G[2][kPair][kPair + 1], R[2][kPair][kPair + 1];  // the inner pass, by turns
    } jac;
    float sums[kGroups - 1][64][16];  // float32 Gram: groups 1-3's sums
    double tree[4][10][64];           // float64 Gram: four warps' tiles, a step of the tree
  } u;
  double rc[kBlock], rs[kBlock], fixed[kBlock][2];  // pair x's c, s, new diagonal
  double ref;                                       // the previous round's reference (warp 0's)
  int rotating[kBlock];
  int any_round[2], any_pair, stop;  // a round's flag, by its parity; the pair's; the sweep's end
};

template <typename T>
constexpr int kFixed = (static_cast<int>(sizeof(Shared<T>)) + 127) / 128 * 128;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A wait past kHang ns traps rather than hang the card (a fault, not a
// state any input reaches).
constexpr unsigned long long kHang = 20000000000ull;

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  const unsigned long long start = now_ns();
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (now_ns() - start > kHang) __trap();
  }
}

// `bytes` from global `src` to this CTA's shared `dst`, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, unsigned long long* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

// d = a b + c on the tensor cores, an 8 x 8 x 4 float64 product: lane l
// holds a = A[l / 4][l % 4], b = B[l % 4][l / 4], c, d = C[l / 4][2 (l % 4) + {0, 1}].
__device__ __forceinline__ void dmma(double (&c)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(c[0]), "+d"(c[1])
               : "d"(a), "d"(b));
}

// Every CTA of the grid past the same point: thread 0 adds its CTA's arrival
// and waits for `target` arrivals in all (the barriers so far times the
// grid), the CTA's writes made visible to the grid before it and the
// grid's after. Every CTA is resident (the host's plan), so it ends.
__device__ __forceinline__ void grid_sync(unsigned* arrived, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(arrived, 1u);
    const unsigned long long start = now_ns();
    while (*static_cast<volatile unsigned*>(arrived) < target) {
      __nanosleep(32);
      if (now_ns() - start > kHang) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// Built with -DTRITD_JACOBI_TRACE (tools/jacobi_phases.py), thread 0 of
// CTA 0 adds the SM cycles of each phase of a visit and of the barriers to
// g_phase_cycles (read by tritd_jacobi_phase_cycles); else nothing.
enum { kAtGram, kAtClusterSync, kAtSum, kAtInner, kAtApplyW, kAtApplyV, kAtGridSync, kAtSweepEnd, kPhases };
#ifdef TRITD_JACOBI_TRACE
__device__ unsigned long long g_phase_cycles[kPhases];
__device__ __forceinline__ void stamp(int phase, long long* last) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const long long t = clock64();
    g_phase_cycles[phase] += static_cast<unsigned long long>(t - *last);
    *last = t;
  }
}
#else
__device__ __forceinline__ void stamp(int, long long*) {}
#endif

// Wt[j][i] = W[i][j] for j < k, i < m, else 0: W is a (tall) or a^T (wide).
template <typename T>
__global__ void prep_w_kernel(const T* __restrict__ a, int64_t q, int wide, int64_t k, int64_t m,
                              T* __restrict__ wt, int64_t ldw, int64_t rows) {
  __shared__ T tile[32][33];
  const int64_t j0 = static_cast<int64_t>(blockIdx.y) * 32, i0 = static_cast<int64_t>(blockIdx.x) * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  if (wide) {
    for (int r = ty; r < 32; r += 8) {
      const int64_t j = j0 + r, i = i0 + tx;
      if (j < rows) wt[j * ldw + i] = (j < k && i < m) ? a[j * q + i] : T(0);
    }
    return;
  }
  for (int r = ty; r < 32; r += 8) {  // a's rows i, its columns j along the threads
    const int64_t i = i0 + r, j = j0 + tx;
    tile[r][tx] = (i < m && j < k) ? a[i * q + j] : T(0);
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {
    const int64_t j = j0 + r, i = i0 + tx;
    if (j < rows) wt[j * ldw + i] = tile[tx][r];
  }
}

// Vt = I in its first k columns, zero elsewhere; the state reset.
template <typename T>
__global__ void prep_v_kernel(T* __restrict__ vt, int64_t k, int64_t ldv, int64_t rows, int* __restrict__ state,
                              int state_len) {
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < state_len; i += blockDim.x) state[i] = 0;
  const int64_t n = rows * ldv;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < n;
       e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t j = e / ldv, i = e % ldv;
    vt[e] = (j == i && j < k) ? T(1) : T(0);
  }
}

// The rotation's t = e / (d + sign(d) hypot(d, e)) (d = g_qq - g_pp, e = 2
// g_pq), in the input's dtype: for a float input the angle need only be
// float's (the rotation built from it in double stays orthogonal to double,
// and what it leaves of g_pq, ~1e-7 of it, is below float's rotation test),
// and float's hypot and division are a fraction of double's latency, which
// is the inner sweep's chain.
template <typename T>
__device__ __forceinline__ double tangent(double d, double e);
template <>
__device__ __forceinline__ double tangent<float>(double d, double e) {
  const float df = static_cast<float>(d), ef = static_cast<float>(e);
  return static_cast<double>(__fdiv_rn(ef, __fadd_rn(df, copysignf(hypotf(df, ef), df))));
}
template <>
__device__ __forceinline__ double tangent<double>(double d, double e) {
  return e / __dadd_rn(d, copysign(hypot(d, e), d));
}

// Rows of a matrix held as Wt or Vt (rows of ld columns, whole tiles), and
// a CTA's slice of their tiles.
template <typename T>
struct Rows {
  T* base;
  int64_t ld;
  int t0, t1;
};

// One CTA's view of a pair's visit: where its slices lie, how it stages,
// and its team: the `team` clusters that take a pair together.
template <typename T>
struct Visit {
  Rows<T> w, v;      // its slices of Wt and Vt (Vt's in columns, not tiles)
  int2 ab;
  int pair;          // the pair's index in its round
  int team, member;  // clusters a pair, this CTA's cluster among them
  double* gsum;      // the team's cluster Grams: [pair][member][kPair * kPair]
  unsigned* count;   // a pair's arrivals of its team's clusters
  double* refs;      // each pair's reference, by the parity of the round: [2][kMaxPairs]
  int pairs;         // pairs a round
  unsigned rounds;   // the rounds before this one
  int chunk;         // tiles a stage holds
  int stages;        // 1: the slice resident; 2 to kRing: chunks through a ring
  int stride;        // a staged row's elements
  T* buf;            // the stages
  Shared<T>* sh;
  unsigned* phases;  // the stages' next parities (bit s)
  long long* last;   // the last stamp (TRITD_JACOBI_TRACE)
};

// Tiles [tf, tf + nt) of the pair's 32 rows of `m` to `dst` (rows of
// v.stride elements), completing on bar[b]: warp 0, a row a lane.
template <typename T>
__device__ __forceinline__ void issue(const Visit<T>& v, const Rows<T>& m, int b, T* dst, int tf, int nt) {
  if (threadIdx.x >= 32) return;
  const unsigned bytes = static_cast<unsigned>(nt * kTile * sizeof(T));
  const int lane = threadIdx.x;
  asm volatile("fence.proxy.async;\n" ::: "memory");  // the generic proxy's reads and writes before the copy's
  if (lane == 0) mbar_expect(&v.sh->bar[b], bytes * kPair);
  __syncwarp();
  bulk_load(dst + static_cast<int64_t>(lane) * v.stride,
            m.base + pair_row(v.ab, lane) * m.ld + static_cast<int64_t>(tf) * kTile, bytes, &v.sh->bar[b]);
}

template <typename T>
__device__ __forceinline__ void wait_bar(const Visit<T>& v, int b) {
  mbar_wait(&v.sh->bar[b], (*v.phases >> b) & 1u);
  *v.phases ^= 1u << b;
}

// body(staged tiles, first tile, tiles) for each chunk of the CTA's slice
// of `m` (one where it is resident), chunk c in stage c % stages, the next
// stages - 1 chunks' copies in flight while one is used; a barrier after
// each body. `again`: the chunks a pass before left in the stages, in
// reverse order: the last `stages` are still staged, so only the others are
// copied again.
template <typename T, typename F>
__device__ __forceinline__ void stream(const Visit<T>& v, const Rows<T>& m, F&& body, bool again = false) {
  const int all = m.t1 - m.t0;
  if (all <= 0) return;
  const int n = (all + v.chunk - 1) / v.chunk, staged = again ? min(v.stages, n) : 0;
  auto chunk = [&](int i) { return again ? n - 1 - i : i; };  // the i-th chunk used
  auto stage = [&](int c) { return v.buf + static_cast<int64_t>(c % v.stages) * kPair * v.stride; };
  auto tile = [&](int c) { return m.t0 + c * v.chunk; };
  auto tiles = [&](int c) { return min(v.chunk, m.t1 - tile(c)); };
  auto copy = [&](int i) {  // the i-th chunk into its stage, which the (i - stages)-th used
    const int c = chunk(i);
    issue(v, m, c % v.stages, stage(c), tile(c), tiles(c));
  };
  for (int i = staged; i < min(n, v.stages); ++i) copy(i);
  for (int i = 0; i < n; ++i) {
    const int next = i + v.stages - 1;  // its stage's last chunk was used at i - 1
    if (i >= 1 && next < n && next >= max(staged, v.stages)) copy(next);
    const int c = chunk(i);
    if (i >= staged) wait_bar(v, c % v.stages);
    body(stage(c), tile(c), tiles(c));
    __syncthreads();
  }
}

// The partial Gram of the staged slices into part (T, 32 x 32).
template <typename T>
__device__ __forceinline__ void partial_gram(const Visit<T>& v, T* part) {
  const int tid = threadIdx.x;
  if constexpr (std::is_same_v<T, float>) {
    // group g of 64 threads: columns [16 g, 16 g + 16) of each tile;
    // thread (ti, tj) of its 8 x 8 the entries (ti + 8 a, tj + 8 b); the
    // groups' sums added in group order. (Blocks of 8 x 8 a thread, half
    // the loads a product, took longer: the loads are not what bounds it.)
    const int g = tid >> 6, lt = tid & 63, ti = lt >> 3, tj = lt & 7, c0 = 16 * g;
    float acc[4][4] = {};
    stream(v, v.w, [&](const float* st, int, int nt) {
      for (int t = 0; t < nt; ++t) {
#pragma unroll
        for (int c = c0; c < c0 + 16; c += 4) {
          float4 x[4], y[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            x[i] = *reinterpret_cast<const float4*>(st + (ti + 8 * i) * v.stride + t * kTile + c);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            y[j] = *reinterpret_cast<const float4*>(st + (tj + 8 * j) * v.stride + t * kTile + c);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
              acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
              acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
              acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
            }
        }
      }
    });
    auto& sums = v.sh->u.sums;
    if (g > 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sums[g - 1][lt][4 * i + j] = acc[i][j];
    }
    __syncthreads();
    if (g == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = acc[i][j];
          for (int h = 0; h < kGroups - 1; ++h) x += sums[h][lt][4 * i + j];
          part[(ti + 8 * i) * kPair + tj + 8 * j] = x;
        }
    }
  } else {
    // warp w: the 4-column steps w, w + 8, ... of each chunk, the next
    // step's fragments loaded before this one's products; the 10 tiles (ri
    // <= rj) of the 4 x 4 of 8 x 8 tiles on DMMA (A and B the same fragments
    // of X); the warps' sums by a fixed tree
    const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    double acc[10][2] = {};
    stream(v, v.w, [&](const double* st, int, int nt) {
      const int steps = nt * (kTile / 4);
      double a[4], next[4];
      auto load = [&](double (&x)[4], int kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) x[r] = st[(8 * r + g) * v.stride + 4 * kk + t4];
      };
      if (w < steps) load(a, w);
      for (int kk = w; kk < steps; kk += kWarps) {
        if (kk + kWarps < steps) load(next, kk + kWarps);
        int idx = 0;
#pragma unroll
        for (int ri = 0; ri < 4; ++ri)
#pragma unroll
          for (int rj = ri; rj < 4; ++rj) dmma(acc[idx++], a[ri], a[rj]);
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = next[r];
      }
    });
    auto& tree = v.sh->u.tree;
    // warps [src, src + n) hand their sums to [dst, dst + n): 4-7 to 0-3,
    // 2-3 to 0-1, 1 to 0
    auto hand = [&](int src, int dst, int n) {
      if (w >= src && w < src + n)
#pragma unroll
        for (int x = 0; x < 10; ++x) {
          tree[w - src][x][2 * lane] = acc[x][0];
          tree[w - src][x][2 * lane + 1] = acc[x][1];
        }
      __syncthreads();
      if (w >= dst && w < dst + n)
#pragma unroll
        for (int x = 0; x < 10; ++x) {
          acc[x][0] += tree[w - dst][x][2 * lane];
          acc[x][1] += tree[w - dst][x][2 * lane + 1];
        }
      __syncthreads();
    };
    static_assert(kWarps == 8, "the tree's steps");
    hand(4, 0, 4);
    hand(2, 0, 2);
    hand(1, 0, 1);
    if (w == 0) {
      int idx = 0;
#pragma unroll
      for (int ri = 0; ri < 4; ++ri)
#pragma unroll
        for (int rj = ri; rj < 4; ++rj, ++idx)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 8 * ri + g, j = 8 * rj + 2 * t4 + e;
            part[i * kPair + j] = acc[idx][e];
            if (ri != rj) part[j * kPair + i] = acc[idx][e];
          }
    }
  }
  __syncthreads();
}

// X <- rt X on a staged chunk of W's rows (tiles [tf, tf + nt)), written
// to Wt.
template <typename T>
__device__ __forceinline__ void apply_chunk(const Visit<T>& v, const T* st, int tf, int nt) {
  const int tid = threadIdx.x;
  const auto& rt = v.sh->rt;
  const int64_t col0 = static_cast<int64_t>(tf) * kTile;
  if constexpr (std::is_same_v<T, float>) {
    for (int col = 2 * tid; col < nt * kTile; col += 2 * kThreads) {  // two columns a thread: R read once for both
      asm volatile("" ::: "memory");  // R's loads stay in the loop: hoisted, its 1024 values would spill
      float2 x[kPair];
#pragma unroll
      for (int j = 0; j < kPair; ++j) x[j] = *reinterpret_cast<const float2*>(st + j * v.stride + col);
#pragma unroll
      for (int i = 0; i < kPair; ++i) {
        float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll
        for (int j = 0; j < kPair; ++j) {
          acc.x = fmaf(rt[i][j], x[j].x, acc.x);
          acc.y = fmaf(rt[i][j], x[j].y, acc.y);
        }
        *reinterpret_cast<float2*>(v.w.base + pair_row(v.ab, i) * v.w.ld + col0 + col) = acc;
      }
    }
  } else {
    // warp w: 8-column groups w, w + 8, ...; Y = R X as 4 x 8 DMMA steps
    // a group, R's fragments held for the whole chunk
    const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    double ar[4][8];
#pragma unroll
    for (int ri = 0; ri < 4; ++ri)
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) ar[ri][ks] = rt[8 * ri + g][4 * ks + t4];
    for (int n0 = 8 * w; n0 < nt * kTile; n0 += 8 * kWarps) {
      double b[8];
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) b[ks] = st[(4 * ks + t4) * v.stride + n0 + g];
#pragma unroll
      for (int ri = 0; ri < 4; ++ri) {
        double c[2] = {0.0, 0.0};
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) dmma(c, ar[ri][ks], b[ks]);
        *reinterpret_cast<double2*>(v.w.base + pair_row(v.ab, 8 * ri + g) * v.w.ld + col0 + n0 + 2 * t4) =
            make_double2(c[0], c[1]);
      }
    }
  }
}

// A CTA's visit of the pair ab in round `round`: its partial Gram, the
// cluster's Gram, the inner pass and, where it rotated, the update of its
// slices of W and V. Returns whether the pair rotated.
template <typename T>
__device__ __forceinline__ bool visit(const Visit<T>& v, cg::cluster_group& cluster, int parity, bool first,
                                      double tol, double rounding) {
  Shared<T>& sh = *v.sh;
  const int tid = threadIdx.x, cs = static_cast<int>(cluster.num_blocks());
  T* part = &sh.part[parity][0][0];
  if (v.w.t1 > v.w.t0) {
    partial_gram(v, part);
  } else {  // no columns of W here
    for (int e = tid; e < kPair * kPair; e += kThreads) part[e] = T(0);
    __syncthreads();
  }
  stamp(kAtGram, v.last);
  // warp 0: the previous round's references of every pair (none before the
  // first round), loaded while the cluster meets
  double prev = 0.0;
  if (tid < v.pairs && v.rounds > 0) prev = __ldcg(v.refs + ((v.rounds - 1) & 1u) * kMaxPairs + tid);
  cluster.sync();
  stamp(kAtClusterSync, v.last);
  // the Gram: the cluster's partials summed in rank order, in double; four
  // entries a thread (rows i0 + 8 l, column j)
  constexpr int kEntries = kPair * kPair / kThreads, kRowStep = kThreads / kPair;
  const int i0 = tid / kPair, j = tid % kPair;
  double sum[kEntries] = {};
  constexpr int kAhead = 4;  // ranks loaded before their sums, which stay in rank order
  for (int r0 = 0; r0 < cs; r0 += kAhead) {
    T got[kAhead][kEntries];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (r0 + u < cs) {
        const T* remote = cluster.map_shared_rank(part, r0 + u);
#pragma unroll
        for (int l = 0; l < kEntries; ++l) got[u][l] = remote[(i0 + kRowStep * l) * kPair + j];
      }
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (r0 + u < cs)
#pragma unroll
        for (int l = 0; l < kEntries; ++l) sum[l] += static_cast<double>(got[u][l]);
  }
  if (v.team > 1) {
    // the team's clusters: rank 0 of each writes its cluster's Gram to
    // global memory and counts it; every CTA of the team waits for all of
    // them, then sums them in member order (L2 reads: written on other SMs)
    double* mine = v.gsum + (static_cast<int64_t>(v.pair) * v.team + v.member) * (kPair * kPair);
    if (cluster.block_rank() == 0) {
#pragma unroll
      for (int l = 0; l < kEntries; ++l) mine[(i0 + kRowStep * l) * kPair + j] = sum[l];
    }
    __syncthreads();
    if (tid == 0) {
      unsigned* count = v.count + v.pair;
      if (cluster.block_rank() == 0) {
        __threadfence();
        atomicAdd(count, 1u);
      }
      const unsigned target = static_cast<unsigned>(v.team) * (v.rounds + 1);
      const unsigned long long start = now_ns();
      while (*static_cast<volatile unsigned*>(count) < target) {
        if (now_ns() - start > kHang) __trap();
      }
      __threadfence();
    }
    __syncthreads();
    const double* all = v.gsum + static_cast<int64_t>(v.pair) * v.team * (kPair * kPair);
#pragma unroll
    for (int l = 0; l < kEntries; ++l) sum[l] = 0.0;
    for (int member = 0; member < v.team; ++member)
#pragma unroll
      for (int l = 0; l < kEntries; ++l)
        sum[l] += __ldcg(all + member * (kPair * kPair) + (i0 + kRowStep * l) * kPair + j);
  }
  auto& G = sh.u.jac.G;
  auto& R = sh.u.jac.R;
#pragma unroll
  for (int l = 0; l < kEntries; ++l) {
    const int i = i0 + kRowStep * l;
    G[0][i][j] = sum[l];
    R[0][i][j] = i == j ? 1.0 : 0.0;
  }
  if (tid < 2) sh.any_round[tid] = 0;
  if (tid == 0) sh.any_pair = 0;
  if (tid < 32) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) prev = fmax(prev, __shfl_xor_sync(0xffffffffu, prev, o));
    if (tid == 0) sh.ref = prev;
  }
  __syncthreads();
  // The reference: the largest Gram diagonal of the previous round's pairs
  // and of this one (fmax: NaN dropped); the next round's visits read it. A
  // column whose diagonal is at most `rounding` times it is rounding (the
  // update's of a large column): no pair of it is tested.
  double ref = sh.ref;
  for (int i = 0; i < kPair; ++i) ref = fmax(ref, G[0][i][i]);
  if (tid == 0 && v.member == 0 && cluster.block_rank() == 0) v.refs[(v.rounds & 1u) * kMaxPairs + v.pair] = ref;
  const double low = rounding * ref;
  // The inner pass. A pair whose Gram passes the rotation test on none of
  // the sweep's pairs rotates nothing: it stops there. Else each of the
  // sweep's 31 (16) rounds 16 threads compute the round's rotations from
  // the current Gram (t = 2 g_pq / (d + sign(d) hypot(d, 2 g_pq)), d = g_qq
  // - g_pp: the smaller root of t^2 + (d / g_pq) t - 1 = 0, Rutishauser's,
  // with one division, `tangent`; c = rsqrt(1 + t^2), s = c t), then thread
  // (a, b) writes the 2 x 2 block of the next G = J G J^T on the rows of the
  // round's pair a and the columns of its pair b, from the same four
  // entries, and two of R = J R's column pairs of pair a; products and sums
  // rounded one by one as the plain version's two phases (rows of G J^T,
  // then of J (G J^T)); two barriers a round.
  bool off = false;  // an entry the sweep tests: every one at the first round, the cross ones after
#pragma unroll
  for (int l = 0; l < kEntries; ++l) {
    const int i = i0 + kRowStep * l;
    off |= (first ? i != j : (i < kBlock) != (j < kBlock)) && G[0][i][i] > low && G[0][j][j] > low &&
           fabs(G[0][i][j]) > tol * sqrt(G[0][i][i]) * sqrt(G[0][j][j]);
  }
  stamp(kAtSum, v.last);
  if (!__syncthreads_or(off)) return false;
  const int a = tid / kBlock, b = tid % kBlock;  // the round's pair of rows, of columns
  int cur = 0;
  const int rounds = first ? kPair - 1 : kBlock;
  for (int round = 0; round < rounds; ++round) {
    const int f = round & 1;
    if (tid == 0) sh.any_round[f ^ 1] = 0;  // the next round's: its last readers are past the last barrier
    const int2 ra = inner_pair(first, round, a), rb = inner_pair(first, round, b);
    if (tid < kBlock) {  // a == 0 here: pair b's rotation
      const double al = G[cur][rb.x][rb.x], be = G[cur][rb.y][rb.y], ga = G[cur][rb.x][rb.y];
      const bool rot = al > low && be > low && fabs(ga) > tol * sqrt(al) * sqrt(be);
      const double t = rot ? tangent<T>(__dsub_rn(be, al), 2.0 * ga) : 0.0;
      const double c = rsqrt(__dadd_rn(1.0, __dmul_rn(t, t)));
      if (rot) sh.any_round[f] = sh.any_pair = 1;
      sh.rc[b] = c;
      sh.rs[b] = c * t;
      sh.rotating[b] = rot;
      sh.fixed[b][0] = __dsub_rn(al, __dmul_rn(t, ga));
      sh.fixed[b][1] = __dadd_rn(be, __dmul_rn(t, ga));
    }
    __syncthreads();
    if (sh.any_round[f]) {  // the same for every thread; a round without a rotation changes nothing
      const int nxt = cur ^ 1;
      {
      const double ca = sh.rc[a], sa = sh.rs[a], cb = sh.rc[b], sb = sh.rs[b];
      double g00, g01, g10, g11;
      if (a == b && sh.rotating[a]) {  // the rotated pair's 2 x 2 block exactly
        g00 = sh.fixed[a][0];
        g11 = sh.fixed[a][1];
        g01 = g10 = 0.0;
      } else {
        const double x00 = G[cur][ra.x][rb.x], x01 = G[cur][ra.x][rb.y];
        const double x10 = G[cur][ra.y][rb.x], x11 = G[cur][ra.y][rb.y];
        // G J^T on the two rows, then J on the result
        const double h00 = __dsub_rn(__dmul_rn(cb, x00), __dmul_rn(sb, x01));
        const double h01 = __dadd_rn(__dmul_rn(sb, x00), __dmul_rn(cb, x01));
        const double h10 = __dsub_rn(__dmul_rn(cb, x10), __dmul_rn(sb, x11));
        const double h11 = __dadd_rn(__dmul_rn(sb, x10), __dmul_rn(cb, x11));
        g00 = __dsub_rn(__dmul_rn(ca, h00), __dmul_rn(sa, h10));
        g01 = __dsub_rn(__dmul_rn(ca, h01), __dmul_rn(sa, h11));
        g10 = __dadd_rn(__dmul_rn(sa, h00), __dmul_rn(ca, h10));
        g11 = __dadd_rn(__dmul_rn(sa, h01), __dmul_rn(ca, h11));
      }
      G[nxt][ra.x][rb.x] = g00;
      G[nxt][ra.x][rb.y] = g01;
      G[nxt][ra.y][rb.x] = g10;
      G[nxt][ra.y][rb.y] = g11;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // R's columns b and b + 16 on pair a's rows
        const int y = b + kBlock * h;
        const double rp = R[cur][ra.x][y], rq = R[cur][ra.y][y];
        R[nxt][ra.x][y] = __dsub_rn(__dmul_rn(ca, rp), __dmul_rn(sa, rq));
        R[nxt][ra.y][y] = __dadd_rn(__dmul_rn(sa, rp), __dmul_rn(ca, rq));
      }
      }
      cur = nxt;
    }
    __syncthreads();
  }
  stamp(kAtInner, v.last);
  if (!sh.any_pair) return false;  // written before the last barrier
#pragma unroll
  for (int l = 0; l < kEntries; ++l) {
    const int i = i0 + kRowStep * l;
    sh.rt[i][j] = static_cast<T>(R[cur][i][j]);
  }
  __syncthreads();
  // the update: W's slice from the stages, the chunks the Gram left there
  // first; V's slice from global memory (L2: written on other SMs), a
  // thread a column
  stream(v, v.w, [&](const T* st, int tf, int nt) { apply_chunk(v, st, tf, nt); }, true);
  stamp(kAtApplyW, v.last);
  for (int col = v.v.t0 + tid; col < v.v.t1; col += kThreads) {
    asm volatile("" ::: "memory");  // as in apply_chunk
    T x[kPair];
#pragma unroll
    for (int i = 0; i < kPair; ++i) x[i] = __ldcg(v.v.base + pair_row(v.ab, i) * v.v.ld + col);
#pragma unroll
    for (int i = 0; i < kPair; ++i) {
      T acc = T(0);
#pragma unroll
      for (int jj = 0; jj < kPair; ++jj) acc = fma(sh.rt[i][jj], x[jj], acc);
      v.v.base[pair_row(v.ab, i) * v.v.ld + col] = acc;
    }
  }
  __syncthreads();
  stamp(kAtApplyV, v.last);
  return true;
}

// All sweeps, one launch: team t of the grid's teams of `team` clusters
// takes pairs t, t + teams, ... of each round, CTA r of a team (member m,
// rank c: r = m cs + c) the r-th slice of Wt's tiles and of Vt's columns; a
// grid barrier after each round; after a sweep's last round every CTA reads
// whether it rotated and stops on a sweep that did not, or at `sweeps`. The
// state records the sweeps run and whether the call converged.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    sweep_kernel(T* __restrict__ wt, int64_t ldw, T* __restrict__ vt, int64_t ldv, int k, int nb, int team,
                 int chunk, int stages, int sweeps, double tol, double rounding, double* __restrict__ gsum,
                 double* __restrict__ refs, int* __restrict__ state) {
  extern __shared__ __align__(128) unsigned char smem[];
  Shared<T>& sh = *reinterpret_cast<Shared<T>*>(smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks()), rank = static_cast<int>(cluster.block_rank());
  const int cid = static_cast<int>(blockIdx.x) / cs, teams = static_cast<int>(gridDim.x) / (cs * team);
  const int member = cid % team, team_id = cid / team, pairs = nb / 2, slices = team * cs, r = member * cs + rank;
  const int tiles = static_cast<int>(ldw / kTile), per = (tiles + slices - 1) / slices;
  const int vper = (k + slices - 1) / slices;
  unsigned phases = 0;
  long long last = clock64();
  const int w0 = min(tiles, r * per), v0 = min(k, r * vper);
  Visit<T> v{{wt, ldw, w0, min(tiles, w0 + per)}, {vt, ldv, v0, min(k, v0 + vper)}, make_int2(0, 0), 0, team,
             member, gsum, reinterpret_cast<unsigned*>(state + kStateHead + sweeps), refs, pairs, 0u, chunk, stages,
             chunk * kTile + kPad, reinterpret_cast<T*>(smem + kFixed<T>), &sh, &phases, &last};
  if (threadIdx.x == 0) {
    for (int b = 0; b < kRing; ++b) mbar_init(&sh.bar[b]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  unsigned visits = 0;
  int ran = 0;
  bool converged = false;
  while (ran < sweeps && !converged) {
    for (int round = 0; round < nb - 1; ++round) {
      for (int pair = team_id; pair < pairs; pair += teams) {
        v.ab = tournament_pair(nb, round, pair);
        v.pair = pair;
        if (visit(v, cluster, static_cast<int>(visits++ & 1u), round == 0, tol, rounding) && r == 0 &&
            threadIdx.x == 0)
          state[kStateHead + ran] = 1;
      }
      stamp(kAtApplyV, &last);  // a visit that did not rotate: its test's end to here
      grid_sync(reinterpret_cast<unsigned*>(state + kArrived), ++v.rounds * gridDim.x);
      stamp(kAtGridSync, &last);
    }
    if (threadIdx.x == 0) sh.stop = !*static_cast<volatile int*>(state + kStateHead + ran);
    __syncthreads();
    converged = sh.stop;
    ++ran;
    __syncthreads();
    stamp(kAtSweepEnd, &last);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    state[kSweepsRun] = ran;
    state[kConverged] = converged;
  }
}

__device__ __forceinline__ double block_sum(double v, double* buf) {
  buf[threadIdx.x] = v;
  __syncthreads();
  for (int h = kNormThreads / 2; h > 0; h >>= 1) {
    if (static_cast<int>(threadIdx.x) < h) buf[threadIdx.x] += buf[threadIdx.x + h];
    __syncthreads();
  }
  return buf[0];
}

// Block j: sig[j] = ||Wt[j]||, the squares summed in double in a fixed order.
// Block 0 also counts the call in `capped` if it stopped at the cap unconverged.
template <typename T>
__global__ void __launch_bounds__(kNormThreads)
    norms_kernel(const T* __restrict__ wt, int64_t ldw, T* __restrict__ sig, const int* __restrict__ state,
                 int* __restrict__ capped) {
  __shared__ double buf[kNormThreads];
  if (blockIdx.x == 0 && threadIdx.x == 0 && !state[kConverged]) atomicAdd(capped, 1);
  const T* row = wt + static_cast<int64_t>(blockIdx.x) * ldw;
  double s = 0.0;
  for (int64_t i = threadIdx.x; i < ldw; i += kNormThreads) {
    const double x = static_cast<double>(row[i]);
    s = fma(x, x, s);
  }
  const double total = block_sum(s, buf);
  if (threadIdx.x == 0) sig[blockIdx.x] = static_cast<T>(sqrt(total));
}

// Whether s_i sorts before s_j in descending order: NaN first, ties in index
// order (torch.sort(descending=True, stable=True)).
template <typename T>
__device__ __forceinline__ bool before(T si, int i, T sj, int j) {
  const bool ni = isnan(si), nj = isnan(sj);
  if (ni != nj) return ni;
  if (!ni && si != sj) return si > sj;
  return i < j;
}

// Block j: its rank r among the k values of sig and s_max (fmax: NaN
// dropped), then s[r] (0 where sig[j] < negligible s_max), wn[r] = Wt[j] / s
// (0 where s is not > 0) over m columns and vs[r] = Vt[j] over k.
template <typename T>
__global__ void __launch_bounds__(kNormThreads)
    write_kernel(const T* __restrict__ wt, int64_t ldw, const T* __restrict__ vt, int64_t ldv,
                 const T* __restrict__ sig, int k, int64_t m, double negligible, T* __restrict__ s,
                 T* __restrict__ wn, T* __restrict__ vs) {
  __shared__ double buf[kNormThreads];
  __shared__ double top;
  const int j = blockIdx.x;
  int count = 0;
  double most = 0.0;
  for (int i = threadIdx.x; i < k; i += kNormThreads) {
    count += before(sig[i], i, sig[j], j);
    most = fmax(most, static_cast<double>(sig[i]));
  }
  const int r = static_cast<int>(block_sum(static_cast<double>(count), buf));
  for (int o = 16; o > 0; o >>= 1) most = fmax(most, __shfl_xor_sync(0xffffffffu, most, o));
  if (threadIdx.x == 0) top = 0.0;
  __syncthreads();
  if (threadIdx.x % 32 == 0) atomicMax(reinterpret_cast<unsigned long long*>(&top), __double_as_longlong(most));
  __syncthreads();
  const T sj = static_cast<double>(sig[j]) < negligible * top ? T(0) : sig[j];
  if (threadIdx.x == 0) s[r] = sj;
  const T* w = wt + static_cast<int64_t>(j) * ldw;
  T* out = wn + static_cast<int64_t>(r) * m;
  const bool keep = sj > T(0);
  for (int64_t i = threadIdx.x; i < m; i += kNormThreads) out[i] = keep ? w[i] / sj : T(0);
  const T* v = vt + static_cast<int64_t>(j) * ldv;
  T* vo = vs + static_cast<int64_t>(r) * k;
  for (int64_t i = threadIdx.x; i < k; i += kNormThreads) vo[i] = v[i];
}

// The sweep kernel's attributes, set once a device (the last one set): the
// H100's whole shared memory, and clusters past the portable 8.
template <typename T>
cudaError_t configure() {
  static int device = -1;
  int now = 0;
  cudaError_t err = cudaGetDevice(&now);
  if (err != cudaSuccess || now == device) return err;
  err = cudaFuncSetAttribute(sweep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sweep_kernel<T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) device = now;
  return err;
}

template <typename T>
cudaLaunchConfig_t sweep_config(int cluster, int clusters, int smem, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster * clusters));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T>
int active_clusters(int cluster, int smem) {
  if (cluster < 1 || cluster > kMaxCluster || smem < kFixed<T> || smem > kSmemLimit) return -cudaErrorInvalidValue;
  cudaError_t err = configure<T>();
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = sweep_config<T>(cluster, 1, smem, nullptr, attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, sweep_kernel<T>, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// The launches of each kernel that returned no error, on the host, in the
// order of ops/device_linalg.py's JACOBI_KERNELS (prep_w, prep_v, sweep,
// norms, write); read and set to 0 by tritd_jacobi_launches.
enum { kKernels = 5 };
int g_launches[kKernels];

template <typename T>
int jacobi_svd(const T* a, int64_t p, int64_t q, T* wt, int64_t ldw, T* vt, int64_t ldv, int* state, int* capped,
               double* gsum, double* refs, T* sig, T* s, T* wn, T* vs, int nb, int cluster, int team, int clusters,
               int chunk, int stages, int smem, int sweeps, double tol, double rounding, double negligible,
               cudaStream_t stream) {
  const int64_t k = p < q ? p : q, m = p < q ? q : p, rows = static_cast<int64_t>(nb) * kBlock;
  const int pairs = nb / 2;
  if (sweeps < 1 || sweeps > kSweeps || cluster < 1 || cluster > kMaxCluster || team < 1 || team > kMaxTeam ||
      pairs > kMaxPairs || clusters < team || clusters % team != 0 || clusters / team > pairs ||
      (clusters / team < pairs && team > 1) || chunk < 1 || stages < 1 || stages > kRing || smem < kFixed<T> ||
      smem > kSmemLimit ||
      static_cast<int64_t>(kFixed<T>) + static_cast<int64_t>(stages) * kPair * (chunk * kTile + kPad) * sizeof(T) >
          static_cast<int64_t>(smem) ||
      ldw % kTile != 0 || ldv < k)
    return cudaErrorInvalidValue;
  cudaError_t err;
#define TRITD_LAUNCHED(kernel)                               \
  if ((err = cudaGetLastError()) != cudaSuccess) return err; \
  ++g_launches[kernel]
  prep_w_kernel<T><<<dim3(static_cast<unsigned>(ldw / 32), static_cast<unsigned>((rows + 31) / 32)), dim3(32, 8), 0,
                     stream>>>(a, q, p < q, k, m, wt, ldw, rows);
  TRITD_LAUNCHED(0);
  prep_v_kernel<T><<<static_cast<unsigned>((rows * ldv + 255) / 256), 256, 0, stream>>>(vt, k, ldv, rows, state,
                                                                                        kStateHead + sweeps + pairs);
  TRITD_LAUNCHED(1);
  if ((err = configure<T>()) != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = sweep_config<T>(cluster, clusters, smem, stream, attr);
  if ((err = cudaLaunchKernelEx(&cfg, sweep_kernel<T>, wt, ldw, vt, ldv, static_cast<int>(k), nb, team, chunk, stages,
                                sweeps, tol, rounding, gsum, refs, state)) != cudaSuccess)
    return err;
  TRITD_LAUNCHED(2);
  norms_kernel<T><<<static_cast<unsigned>(k), kNormThreads, 0, stream>>>(wt, ldw, sig, state, capped);
  TRITD_LAUNCHED(3);
  write_kernel<T><<<static_cast<unsigned>(k), kNormThreads, 0, stream>>>(wt, ldw, vt, ldv, sig, static_cast<int>(k), m,
                                                                         negligible, s, wn, vs);
  TRITD_LAUNCHED(4);
#undef TRITD_LAUNCHED
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The geometry ops/device_linalg.py plans with; its wrapper raises if they
// differ from the module's.
int tritd_jacobi_block(void) { return kBlock; }
int tritd_jacobi_tile(void) { return kTile; }
int tritd_jacobi_sweeps(void) { return kSweeps; }
int tritd_jacobi_fixed_smem(int f64) { return f64 ? kFixed<double> : kFixed<float>; }

// The launches of each kernel since the last call into out (kKernels ints,
// in the order of JACOBI_KERNELS), then set to 0.
int tritd_jacobi_launches(void* out) {
  int* n = static_cast<int*>(out);
  for (int i = 0; i < kKernels; ++i) {
    n[i] = g_launches[i];
    g_launches[i] = 0;
  }
  return 0;
}

#ifdef TRITD_JACOBI_TRACE
// The phases' cycles so far into out (kPhases values), then set to 0.
int tritd_jacobi_phase_cycles(void* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
  unsigned long long zero[kPhases] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  return err;
}
#endif

// How many clusters of `cluster` CTAs with `smem` bytes of shared memory
// each the current device holds at once (cudaOccupancyMaxActiveClusters),
// or minus the CUDA error.
int tritd_jacobi_active_clusters(int f64, int cluster, int smem) {
  return f64 ? active_clusters<double>(cluster, smem) : active_clusters<float>(cluster, smem);
}

// a (p x q, row-major, contiguous) -> s (k), wn (k x m), vs (k x k), with
// the scratch Wt (nb kBlock x ldw, ldw whole tiles), Vt (nb kBlock x ldv),
// state (kStateHead + sweeps + nb / 2 ints: converged, sweeps run, the grid
// barrier's count, a flag a sweep, a count a pair), capped (1 int, the
// count of calls that stopped at the cap, kept by the caller), gsum (nb / 2
// x team x 32 x 32 doubles: a team's cluster Grams; unused for a team of
// one), refs (2 x 32 doubles: each pair's reference, by the round's
// parity), sig (k); all on the device, allocated by the caller. The plan: nb
// blocks, `clusters` clusters of `cluster` CTAs, `team` clusters a pair,
// `stages` stages of `chunk` tiles, `smem` bytes of shared memory a CTA, at
// most `sweeps` sweeps; the rotation test's tolerance `tol` and floor
// `rounding` (over the reference), and `negligible` (the fraction of s_max
// below which a singular value is 0). Returns cudaErrorInvalidValue for a
// plan it does not take, else cudaGetLastError() of the first launch that
// failed, else 0.
int tritd_jacobi_svd_f32(const void* a, int64_t p, int64_t q, void* wt, int64_t ldw, void* vt, int64_t ldv,
                         void* state, void* capped, void* gsum, void* refs, void* sig, void* s, void* wn, void* vs,
                         int nb, int cluster, int team, int clusters, int chunk, int stages, int smem, int sweeps,
                         double tol, double rounding, double negligible, void* stream) {
  return jacobi_svd<float>(static_cast<const float*>(a), p, q, static_cast<float*>(wt), ldw, static_cast<float*>(vt),
                           ldv, static_cast<int*>(state), static_cast<int*>(capped), static_cast<double*>(gsum),
                           static_cast<double*>(refs), static_cast<float*>(sig), static_cast<float*>(s),
                           static_cast<float*>(wn), static_cast<float*>(vs), nb, cluster, team, clusters, chunk, stages,
                           smem, sweeps, tol, rounding, negligible, static_cast<cudaStream_t>(stream));
}

int tritd_jacobi_svd_f64(const void* a, int64_t p, int64_t q, void* wt, int64_t ldw, void* vt, int64_t ldv,
                         void* state, void* capped, void* gsum, void* refs, void* sig, void* s, void* wn, void* vs,
                         int nb, int cluster, int team, int clusters, int chunk, int stages, int smem, int sweeps,
                         double tol, double rounding, double negligible, void* stream) {
  return jacobi_svd<double>(static_cast<const double*>(a), p, q, static_cast<double*>(wt), ldw,
                            static_cast<double*>(vt), ldv, static_cast<int*>(state), static_cast<int*>(capped),
                            static_cast<double*>(gsum), static_cast<double*>(refs), static_cast<double*>(sig),
                            static_cast<double*>(s), static_cast<double*>(wn), static_cast<double*>(vs), nb, cluster,
                            team, clusters, chunk, stages, smem, sweeps, tol, rounding, negligible,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
