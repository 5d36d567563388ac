// The thin SVD (u, s, vh) of a real p x q matrix by blocked one-sided
// (Hestenes) Jacobi, for ops/device_linalg.py::jacobi_svd.
//
// It replaces no Pallas kernel. It stands for `jnp.linalg.svd` inside the
// reference's `fori_loop`s (the SVT's "svd" route, tritd_tpu/ops/svt.py:143,
// under tritd_tpu/baselines/{ttnn,rtrc,rc_fctn,trpca}.py), which XLA lowers
// to a library call that checks nothing on the host. No cuSOLVER SVD driver
// can be captured in a CUDA graph: gesvdj, Xgesvd and Xgesvdp read back to
// the host inside the call (`python -m tritd_tpu_torch.tools.capture_linalg`).
// This one reads nothing back: its sweeps are a fixed sequence of launches
// that a graph holds, and a flag on the device makes the launches after
// convergence return at once.
//
// What it computes, as torch.linalg.svd(a, full_matrices=False): k = min(p,
// q), s descending (ties in index order, NaN first, as torch's stable sort),
// u (p, k), vh (k, q). It works on the tall form W (m x k, m >= k): the input,
// or its transpose, held as Wt (its k columns as rows of length ldw, zero
// padded to whole tiles and to nb blocks of kBlock rows) beside Vt (the
// columns of V as rows, V = I at the start). At the end s_j = ||W e_j||,
// the normalized rows of Wt (zero where s_j = 0) and the rows of Vt, sorted
// by s, are W's U^T and V^T: for a tall input u = wn^T, vh = vs; for a wide
// one u = vs^T, vh = wn.
//
// A sweep pairs the nb blocks by a round-robin tournament (nb - 1 rounds of
// nb / 2 disjoint pairs; a zero block makes nb even). A round is three
// launches, no grid-wide synchronization:
//   1. gram:   each pair's 32 x 32 Gram X X^T (X its 32 rows of Wt), the m
//              columns split into slices so that the card is full; each
//              (pair, slice) block writes its partial Gram;
//   2. rotate: one block a pair sums the slices' partials in slice order in
//              double (no atomics: a replay gives the eager call's bits) and
//              runs a cyclic Jacobi pass over the 32 x 32 Gram in shared
//              memory, in double, rounds of 16 disjoint rotations: at a
//              sweep's first round every pair of the 32 (the same
//              tournament, 31 rounds), at the others the 256 pairs across
//              the two blocks (16 rounds), so that a sweep rotates each pair
//              of columns once; each rotation only where
//              |g_pq| > tol sqrt(g_pp) sqrt(g_qq) (tol = sqrt(m) eps of the
//              input's dtype, LAPACK's gesvj test), accumulating R = J_31 ...
//              J_1; it stores R in the input's dtype and whether it rotated;
//   3. apply:  X <- R X for W's and V's rows of every pair that rotated, a
//              thread a column.
// A fourth launch ends the sweep: no rotation in it sets the converged flag,
// which every launch reads first. JACOBI_SWEEPS sweeps are launched; a call
// whose last sweep still rotated adds one to `capped`, a count on the device
// that the caller keeps across calls and reads when it reads anything else
// (ops/device_linalg.py::jacobi_capped).
//
// Design, and what bounds it. The flops of a round are those of two GEMMs of
// the tall matrix, 64 m k each (the Gram and the update; V adds 64 k^2),
// over about 8 - 14 sweeps of nb - 1 rounds; the L2 holds W (20 MB at the
// taxi cuts in float32). So the kernel is bound by operations and by the
// latency of its launches and of the small Jacobi between them, not by
// device memory. Against that:
//   * blocks of 16 columns (pairs of 32 rows) give nb / 2 pairs a round to
//     spread over the SMs, and 4 groups of threads in a Gram block split each
//     tile of 64 columns, the next tile loaded while one is summed; the
//     slices fill about four blocks an SM;
//   * one inner pass a visit of a pair (no inner convergence), and after a
//     sweep's first round only across the two blocks: on the CPU rehearsals
//     it took as many outer sweeps (within one) as an inner solve to
//     convergence or a full inner sweep every visit, with half the inner
//     rounds of the latter and fewer rotations (so less rounding in V);
//   * the inner problem in double for a float32 input: in float32 the
//     accumulated rotations left V orthogonal to 1.5e-4 at 2000 x 200, in
//     double to 6e-7;
//   * no preconditioning QR: torch.linalg.qr of a 4800 x 512 matrix took 5.0
//     ms on the H100, a fifth of the whole SVD it would precondition at
//     10000 x 500;
//   * a pair that did not rotate skips its update, and every launch after
//     convergence returns at once (their cost is the launches alone).
// The bound the smoke holds it to is that of an SVD, not of these sweeps.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 16;               // columns of W a block holds
constexpr int kPair = 2 * kBlock;        // rows of a pair
constexpr int kTile = 64;                // columns of Wt a Gram step loads at once (ldw is a multiple)
constexpr int kGroups = 4;               // groups of 64 threads in a Gram block, 16 columns of a tile each
constexpr int kGramThreads = 64 * kGroups;
constexpr int kRotateThreads = 256;      // four entries of the pair's Gram and R a thread
constexpr int kApplyThreads = 128;       // one column of Wt (or Vt) a thread
constexpr int kNormThreads = 256;

enum { kConverged = 0, kRotated = 1, kSweeps = 2, kStateLen = 3 };

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

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
};

template <typename T>
__device__ __forceinline__ T component(const typename Vec<T>::type& v, int c);
template <>
__device__ __forceinline__ float component<float>(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}
template <>
__device__ __forceinline__ double component<double>(const double2& v, int c) {
  return c == 0 ? v.x : v.y;
}

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
__global__ void prep_v_kernel(T* __restrict__ vt, int64_t k, int64_t ldv, int64_t rows, int* __restrict__ state) {
  if (blockIdx.x == 0 && threadIdx.x < kStateLen) state[threadIdx.x] = 0;
  const int64_t n = rows * ldv;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < n;
       e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t j = e / ldv, i = e % ldv;
    vt[e] = (j == i && j < k) ? T(1) : T(0);
  }
}

// Block (slice, pair): the partial Gram of the pair's 32 rows of Wt over the
// slice's tiles. Group g of 64 threads takes columns [16 g, 16 g + 16) of
// each tile, thread (ti, tj) of its 8 x 8 the entries (ti + 8 a, tj + 8 b);
// the groups' sums are added in group order at the end. (Summing only the
// tiles on or above the diagonal, 144 threads a block, saved 44% of the
// products but took longer: fewer warps hid less of the loads' latency.)
template <typename T>
__global__ void __launch_bounds__(kGramThreads)
    gram_kernel(const T* __restrict__ wt, int64_t ldw, int nb, int round, int tiles, int per_slice,
                T* __restrict__ partial, const int* __restrict__ state) {
  if (state[kConverged]) return;
  using V = typename Vec<T>::type;
  constexpr int kV = Vec<T>::n;
  constexpr int kStride = kTile + kV;  // 8 consecutive rows on 8 distinct 16-byte bank groups
  __shared__ __align__(16) T tile[kPair][kStride];
  __shared__ T sums[kGroups - 1][64][16];
  const int pair = blockIdx.y, slice = blockIdx.x, tid = threadIdx.x;
  const int2 ab = tournament_pair(nb, round, pair);
  const int g = tid >> 6, lt = tid & 63, ti = lt >> 3, tj = lt & 7;
  T acc[4][4];
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) acc[x][y] = T(0);
  const int first = slice * per_slice, last = min(tiles, first + per_slice);
  // each thread's share of a tile, the next tile's loaded while this one is summed
  constexpr int kRowVecs = kTile / kV, kLoads = kPair * kRowVecs / kGramThreads;
  V next[kLoads];
  auto load = [&](int t) {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int v = tid + l * kGramThreads, row = v / kRowVecs, c = v % kRowVecs;
      next[l] = *reinterpret_cast<const V*>(wt + pair_row(ab, row) * ldw + static_cast<int64_t>(t) * kTile + c * kV);
    }
  };
  if (first < last) load(first);
  for (int t = first; t < last; ++t) {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int v = tid + l * kGramThreads;
      *reinterpret_cast<V*>(&tile[v / kRowVecs][(v % kRowVecs) * kV]) = next[l];
    }
    __syncthreads();
    if (t + 1 < last) load(t + 1);
#pragma unroll
    for (int c = 16 * g; c < 16 * g + 16; c += kV) {
      V x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const V*>(&tile[ti + 8 * i][c]);
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = *reinterpret_cast<const V*>(&tile[tj + 8 * j][c]);
#pragma unroll
      for (int e = 0; e < kV; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fma(component<T>(x[i], e), component<T>(y[j], e), acc[i][j]);
    }
    __syncthreads();
  }
  if (g > 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sums[g - 1][lt][4 * i + j] = acc[i][j];
  }
  __syncthreads();
  if (g > 0) return;
  T* out = partial + (static_cast<int64_t>(pair) * gridDim.x + slice) * (kPair * kPair);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      T v = acc[i][j];
      for (int h = 0; h < kGroups - 1; ++h) v += sums[h][lt][4 * i + j];
      out[(ti + 8 * i) * kPair + tj + 8 * j] = v;
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

// Block pair: the pair's Gram from the slices' partials (summed in slice
// order, in double), one Jacobi sweep over it in double (`inner_pair`: every
// pair of its 32 indices at an outer sweep's first round, the 256 across its
// two blocks after), R stored in T, the pair's flag and the sweep's. G and R
// in two buffers of shared memory. A pair whose Gram passes the rotation
// test on none of the sweep's pairs rotates nothing: it stops there. Else
// each of the sweep's 31 (16) rounds 16 threads compute the
// round's rotations from the current Gram (t = 2 g_pq / (d + sign(d)
// hypot(d, 2 g_pq)), d = g_qq - g_pp: the smaller root of t^2 + (d / g_pq) t
// - 1 = 0, Rutishauser's, with one division, `tangent`; c = rsqrt(1 + t^2),
// s = c t), then thread (a, b) writes the 2 x 2 block of the next G = J G J^T
// on the rows of the round's pair a and the columns of its pair b, from the
// same four entries, and two of R = J R's column pairs of pair a; products
// and sums rounded one by one as the plain version's two phases (rows of
// G J^T, then of J (G J^T)); two barriers a round. The update reads each
// entry of G and R once a round: shared memory's bandwidth, not the
// rotations' arithmetic, was the round's cost when a thread read all four
// of an entry's neighbours.
template <typename T>
__global__ void __launch_bounds__(kRotateThreads)
    rotate_kernel(const T* __restrict__ partial, int slices, double tol, int first, T* __restrict__ rmat,
                  int* __restrict__ rotated, int* __restrict__ state) {
  if (state[kConverged]) return;
  constexpr int kEntries = kPair * kPair / kRotateThreads, kRowStep = kRotateThreads / kPair;
  static_assert(kRotateThreads == kBlock * kBlock, "a thread a pair of the round's pairs");
  __shared__ double G[2][kPair][kPair + 1];
  __shared__ double R[2][kPair][kPair + 1];
  __shared__ double rc[kBlock], rs[kBlock], fixed[kBlock][2];  // pair x's c, s, new diagonal
  __shared__ int rotating[kBlock];
  __shared__ int any_round[2], any_pair;  // a round's flag, by its parity; the sweep's
  const int pair = blockIdx.x, tid = threadIdx.x, i0 = tid / kPair, j = tid % kPair;
  const T* src = partial + static_cast<int64_t>(pair) * slices * (kPair * kPair) + tid;
  constexpr int kAhead = 8;  // slices loaded before their sums, which stay in slice order
  double sum[kEntries] = {};
  int s = 0;
  for (; s + kAhead <= slices; s += kAhead) {
    T v[kAhead][kEntries];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
#pragma unroll
      for (int l = 0; l < kEntries; ++l) v[u][l] = src[static_cast<int64_t>(s + u) * (kPair * kPair) + l * kRotateThreads];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
#pragma unroll
      for (int l = 0; l < kEntries; ++l) sum[l] += static_cast<double>(v[u][l]);
  }
  for (; s < slices; ++s)
#pragma unroll
    for (int l = 0; l < kEntries; ++l)
      sum[l] += static_cast<double>(src[static_cast<int64_t>(s) * (kPair * kPair) + l * kRotateThreads]);
#pragma unroll
  for (int l = 0; l < kEntries; ++l) {
    const int i = i0 + kRowStep * l;
    G[0][i][j] = sum[l];
    R[0][i][j] = i == j ? 1.0 : 0.0;
  }
  if (tid < 2) any_round[tid] = 0;
  if (tid == 0) any_pair = 0;
  __syncthreads();
  bool off = false;  // an entry the sweep tests: every one at the first round, the cross ones after
#pragma unroll
  for (int l = 0; l < kEntries; ++l) {
    const int i = i0 + kRowStep * l;
    off |= (first ? i != j : (i < kBlock) != (j < kBlock)) &&
           fabs(G[0][i][j]) > tol * sqrt(G[0][i][i]) * sqrt(G[0][j][j]);
  }
  if (!__syncthreads_or(off)) {
    if (tid == 0) rotated[pair] = 0;
    return;
  }
  const int a = tid / kBlock, b = tid % kBlock;  // the round's pair of rows, of columns
  int cur = 0;
  const int rounds = first ? kPair - 1 : kBlock;
  for (int round = 0; round < rounds; ++round) {
    const int f = round & 1;
    if (tid == 0) any_round[f ^ 1] = 0;  // the next round's: its last readers are past the last barrier
    const int2 ra = inner_pair(first, round, a), rb = inner_pair(first, round, b);
    if (tid < kBlock) {  // a == 0 here: pair b's rotation
      const double al = G[cur][rb.x][rb.x], be = G[cur][rb.y][rb.y], ga = G[cur][rb.x][rb.y];
      const bool rot = fabs(ga) > tol * sqrt(al) * sqrt(be);
      const double t = rot ? tangent<T>(__dsub_rn(be, al), 2.0 * ga) : 0.0;
      const double c = rsqrt(__dadd_rn(1.0, __dmul_rn(t, t)));
      if (rot) any_round[f] = any_pair = 1;
      rc[b] = c;
      rs[b] = c * t;
      rotating[b] = rot;
      fixed[b][0] = __dsub_rn(al, __dmul_rn(t, ga));
      fixed[b][1] = __dadd_rn(be, __dmul_rn(t, ga));
    }
    __syncthreads();
    if (any_round[f]) {  // the same for every thread; a round without a rotation changes nothing
      const int nxt = cur ^ 1;
      const double ca = rc[a], sa = rs[a], cb = rc[b], sb = rs[b];
      double g00, g01, g10, g11;
      if (a == b && rotating[a]) {  // the rotated pair's 2 x 2 block exactly
        g00 = fixed[a][0];
        g11 = fixed[a][1];
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
      cur = nxt;
    }
    __syncthreads();
  }
  if (any_pair) {  // written before the last barrier
#pragma unroll
    for (int l = 0; l < kEntries; ++l) {
      const int i = i0 + kRowStep * l;
      rmat[static_cast<int64_t>(pair) * (kPair * kPair) + i * kPair + j] = static_cast<T>(R[cur][i][j]);
    }
    if (tid == 0) {
      rotated[pair] = 1;
      state[kRotated] = 1;
    }
  } else if (tid == 0) {
    rotated[pair] = 0;
  }
}

// Block (chunk, pair): X <- R X on a chunk of columns of the pair's rows, of
// Wt for the first w_chunks chunks, of Vt after; a thread a column.
template <typename T>
__global__ void __launch_bounds__(kApplyThreads)
    apply_kernel(T* __restrict__ wt, int64_t ldw, int w_chunks, T* __restrict__ vt, int64_t ldv, int nb, int round,
                 const T* __restrict__ rmat, const int* __restrict__ rotated, const int* __restrict__ state) {
  if (state[kConverged]) return;
  const int pair = blockIdx.y;
  if (!rotated[pair]) return;
  __shared__ __align__(16) T R[kPair][kPair];
  for (int e = threadIdx.x; e < kPair * kPair; e += kApplyThreads)
    R[e / kPair][e % kPair] = rmat[static_cast<int64_t>(pair) * (kPair * kPair) + e];
  __syncthreads();
  const bool on_w = static_cast<int>(blockIdx.x) < w_chunks;
  T* base = on_w ? wt : vt;
  const int64_t ld = on_w ? ldw : ldv;
  const int64_t col = static_cast<int64_t>(on_w ? blockIdx.x : blockIdx.x - w_chunks) * kApplyThreads + threadIdx.x;
  if (col >= ld) return;
  const int2 ab = tournament_pair(nb, round, pair);
  T x[kPair];
#pragma unroll
  for (int i = 0; i < kPair; ++i) x[i] = base[pair_row(ab, i) * ld + col];
#pragma unroll
  for (int i = 0; i < kPair; ++i) {
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < kPair; ++j) acc = fma(R[i][j], x[j], acc);
    base[pair_row(ab, i) * ld + col] = acc;
  }
}

__global__ void end_sweep_kernel(int* __restrict__ state) {
  if (state[kConverged]) return;
  state[kSweeps] += 1;
  if (!state[kRotated]) state[kConverged] = 1;
  state[kRotated] = 0;
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

// Block j: its rank r among the k values of sig, then s[r], wn[r] = Wt[j] /
// s (0 where s is not > 0) over m columns and vs[r] = Vt[j] over k.
template <typename T>
__global__ void __launch_bounds__(kNormThreads)
    write_kernel(const T* __restrict__ wt, int64_t ldw, const T* __restrict__ vt, int64_t ldv,
                 const T* __restrict__ sig, int k, int64_t m, T* __restrict__ s, T* __restrict__ wn,
                 T* __restrict__ vs) {
  __shared__ double buf[kNormThreads];
  const int j = blockIdx.x;
  const T sj = sig[j];
  int count = 0;
  for (int i = threadIdx.x; i < k; i += kNormThreads) count += before(sig[i], i, sj, j);
  const int r = static_cast<int>(block_sum(static_cast<double>(count), buf));
  if (threadIdx.x == 0) s[r] = sj;
  const T* w = wt + static_cast<int64_t>(j) * ldw;
  T* out = wn + static_cast<int64_t>(r) * m;
  const bool keep = sj > T(0);
  for (int64_t i = threadIdx.x; i < m; i += kNormThreads) out[i] = keep ? w[i] / sj : T(0);
  const T* v = vt + static_cast<int64_t>(j) * ldv;
  T* vo = vs + static_cast<int64_t>(r) * k;
  for (int64_t i = threadIdx.x; i < k; i += kNormThreads) vo[i] = v[i];
}

template <typename T>
int jacobi_svd(const T* a, int64_t p, int64_t q, T* wt, int64_t ldw, T* vt, int64_t ldv, T* partial, T* rmat,
               int* rotated, int* state, int* capped, T* sig, T* s, T* wn, T* vs, int nb, int slices, int per_slice,
               int sweeps, double tol, cudaStream_t stream) {
  const int64_t k = p < q ? p : q, m = p < q ? q : p, rows = static_cast<int64_t>(nb) * kBlock;
  const int pairs = nb / 2, tiles = static_cast<int>(ldw / kTile);
  const int w_chunks = static_cast<int>((ldw + kApplyThreads - 1) / kApplyThreads);
  const int v_chunks = static_cast<int>((ldv + kApplyThreads - 1) / kApplyThreads);
  cudaError_t err;
#define TRITD_LAUNCHED()                                \
  if ((err = cudaGetLastError()) != cudaSuccess) return err
  prep_w_kernel<T><<<dim3(static_cast<unsigned>(ldw / 32), static_cast<unsigned>((rows + 31) / 32)), dim3(32, 8), 0,
                     stream>>>(a, q, p < q, k, m, wt, ldw, rows);
  TRITD_LAUNCHED();
  prep_v_kernel<T><<<static_cast<unsigned>((rows * ldv + 255) / 256), 256, 0, stream>>>(vt, k, ldv, rows, state);
  TRITD_LAUNCHED();
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    for (int round = 0; round < nb - 1; ++round) {
      gram_kernel<T><<<dim3(slices, pairs), kGramThreads, 0, stream>>>(wt, ldw, nb, round, tiles, per_slice, partial,
                                                                       state);
      TRITD_LAUNCHED();
      rotate_kernel<T><<<pairs, kRotateThreads, 0, stream>>>(partial, slices, tol, round == 0, rmat, rotated,
                                                            state);
      TRITD_LAUNCHED();
      apply_kernel<T><<<dim3(w_chunks + v_chunks, pairs), kApplyThreads, 0, stream>>>(wt, ldw, w_chunks, vt, ldv, nb,
                                                                                      round, rmat, rotated, state);
      TRITD_LAUNCHED();
    }
    end_sweep_kernel<<<1, 1, 0, stream>>>(state);
    TRITD_LAUNCHED();
  }
  norms_kernel<T><<<static_cast<unsigned>(k), kNormThreads, 0, stream>>>(wt, ldw, sig, state, capped);
  TRITD_LAUNCHED();
  write_kernel<T><<<static_cast<unsigned>(k), kNormThreads, 0, stream>>>(wt, ldw, vt, ldv, sig, static_cast<int>(k), m,
                                                                         s, wn, vs);
  TRITD_LAUNCHED();
#undef TRITD_LAUNCHED
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The geometry ops/device_linalg.py plans with; its wrapper raises if they
// differ from the module's.
int tritd_jacobi_block(void) { return kBlock; }
int tritd_jacobi_tile(void) { return kTile; }

// a (p x q, row-major, contiguous) -> s (k), wn (k x m), vs (k x k), with
// the scratch Wt (nb kBlock x ldw), Vt (nb kBlock x ldv), partial (nb / 2 x
// slices x 32 x 32), rmat (nb / 2 x 32 x 32), rotated (nb / 2 ints), state
// (3 ints: converged, rotated in this sweep, sweeps run), capped (1 int, the
// count of calls that stopped at the cap, kept by the caller), sig (k); all on
// the device, allocated by the caller. Returns cudaGetLastError() of the
// first launch that failed, else 0.
int tritd_jacobi_svd_f32(const void* a, int64_t p, int64_t q, void* wt, int64_t ldw, void* vt, int64_t ldv,
                         void* partial, void* rmat, void* rotated, void* state, void* capped, void* sig, void* s,
                         void* wn, void* vs, int nb, int slices, int per_slice, int sweeps, double tol, void* stream) {
  return jacobi_svd<float>(static_cast<const float*>(a), p, q, static_cast<float*>(wt), ldw, static_cast<float*>(vt),
                           ldv, static_cast<float*>(partial), static_cast<float*>(rmat), static_cast<int*>(rotated),
                           static_cast<int*>(state), static_cast<int*>(capped), static_cast<float*>(sig),
                           static_cast<float*>(s), static_cast<float*>(wn), static_cast<float*>(vs), nb, slices,
                           per_slice, sweeps, tol, static_cast<cudaStream_t>(stream));
}

int tritd_jacobi_svd_f64(const void* a, int64_t p, int64_t q, void* wt, int64_t ldw, void* vt, int64_t ldv,
                         void* partial, void* rmat, void* rotated, void* state, void* capped, void* sig, void* s,
                         void* wn, void* vs, int nb, int slices, int per_slice, int sweeps, double tol, void* stream) {
  return jacobi_svd<double>(static_cast<const double*>(a), p, q, static_cast<double*>(wt), ldw,
                            static_cast<double*>(vt), ldv, static_cast<double*>(partial), static_cast<double*>(rmat),
                            static_cast<int*>(rotated), static_cast<int*>(state), static_cast<int*>(capped),
                            static_cast<double*>(sig), static_cast<double*>(s), static_cast<double*>(wn),
                            static_cast<double*>(vs), nb, slices, per_slice, sweeps, tol,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
