// SOFIA's solves inside its masked CP-ALS loop (baselines/sofia.py), as
// kernels that a CUDA graph can hold. None replaces a Pallas kernel: the
// reference computes them with jnp inside its device loops,
// `jax.vmap(... jnp.linalg.pinv(g))` (tritd_tpu/baselines/sofia.py:69) and
// `_mode3_gauss_seidel` (:121), its systems and the `lax.scan` of the mode-3
// Gauss-Seidel sweep (:175). torch's pinv checks LAPACK's `info` on the
// host, so no graph can capture it; the sweep written in torch is about four
// launches a row, and its systems about thirty small launches.
//
// pinv_rows: out[i] = rhs[i] @ pinv(gram[i]) for n symmetric r x r grams by
// cyclic Jacobi, then pinv = V diag(1/lambda where |lambda| > cut) V^T with
// cut = rtol * max|lambda|, which for a symmetric matrix is the SVD
// pseudo-inverse (singular values |lambda|) with torch's rule, S > cut. An
// all-zero gram has cut 0 and keeps no eigenvalue: its row is exactly zero,
// the min-norm answer. Bound: latency. A rotation is a chain of a division,
// a hypot, a square root and a division, and a gram needs a few sweeps of
// r (r - 1) / 2 rotations; the n = 23..320 grams of SOFIA's modes are a few
// kilobytes. So for r <= ThreadRank (8 in float, 5 in double: the matrix
// and V in registers, two r x r arrays) one thread holds a gram, unrolled
// for its r, 32 grams a warp and kPinvThreads a block (taxi's 100 grams in
// one block): the floor is a launch and one gram's sweeps, with no shared
// memory or warp barrier on the chain. Larger r keeps one warp a matrix, a
// lane a column, the matrix in shared memory.
//
// mode3_sweep: the whole mode-3 step of an ALS iteration in one launch,
// from u3 (n3, r) (the old rows), rhs_base (n3, r) and gram_base (n3, r,
// r). For each row t, with the flags has_prev = t > 0, has_next = t < n3-1,
// use_fwd = t < n3-m, use_bwd = t >= m:
//   d[t]    = lam1 (has_prev + has_next) + lam2 (use_fwd + use_bwd),
//   inv[t]  = (gram_base[t] + d[t] I)^-1,
//   rhs0[t] = rhs_base[t] + lam1 has_next u3[t+1 mod n3] + lam2 use_fwd u3[t+m mod n3],
// and then the chain in the order of t,
//   out[t]  = (rhs0[t] + lam1 out[t-1] [t > 0] + lam2 out[t-m] [t >= m]) @ inv[t].
// For r <= 3 the inverse is the adjugate form of the plain version
// (ops/sofia_kernels.py::_spd_inverse) in its order and rounding (the *_rn
// intrinsics: no FMA contraction), so the inverses and rhs0 are its bits;
// for 4 <= r <= 32 a Cholesky factorization and inverse in shared memory,
// NaN where a pivot is not positive, as `cholesky_ex` gives.
//
// What bounds it: the chain, n3 dependent rows of r + 1 dependent FMAs
// (the coupling, then the r-term product), 16 cycles a row at r = 3 in
// float, where the old gauss_seidel_sweep paid a global-memory round trip a
// row (its loads issued when the row began). Everything else is off the
// chain, so one block runs two roles at once:
// - kProducerWarps warps build the systems a tile of rows at a time into a
//   ring of up to kMaxBuffers tile buffers in shared memory (the inverse
//   and rhs0 of a row side by side, padded to 16 bytes): a thread a row for
//   r <= 3, a warp a row (its Cholesky) above. They hand a full tile to the
//   chain with a named barrier (bar.arrive; the chain waits with bar.sync
//   only if it catches up) and wait for a buffer the chain has released.
// - Warp 0 runs the chain. For r <= ThreadRank one thread,
//   unrolled for its r, holds rows and inputs in registers; every lane of
//   the warp runs the same chain on the same values (their stores
//   coincide), which keeps the barriers warp-uniform. One warp issues in
//   order, so the step of a row is cut to its arithmetic and a few 16-byte
//   shared-memory accesses that overlap it (chain_rows): the inputs load
//   D rows ahead into D + 1 register sets, the rows out go to a staging
//   ring in shared memory that is also the delay line of the rows m back
//   (the reference's `ring`), and the lanes copy them out a tile at a time;
//   rhs0 + lam2 out[t-m] is summed off the chain (for m = 1 the two terms
//   are one FMA with lam1 + lam2), so only lam1 out[t-1] and the product lie
//   on it. Above ThreadRank a lane holds a column, the product broadcasts
//   x by shuffles, and the rows m back stay in a shared-memory delay line.
//   Where the delay line does not fit, either form reads the rows m back
//   from out.
// The issue of the step's instructions and shared-memory accesses, more
// than the FMA latency, sets the pace a row (PERF.md section 6).
//
// Each entry returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for an r outside 1..kSofiaMaxRank (or m < 1); n == 0
// launches nothing.
//
// gauss_seidel_sweep: the sweep alone (inputs rhs0 and inv), one warp
// walking the rows, a lane a column, each row's loads issued when it
// begins. Off the main path: the yardstick of mode3_sweep on the same card.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kSofiaMaxRank = 32;
constexpr int kWarp = 32;
constexpr int kMaxSweeps = 40;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPinvThreads = 128;
constexpr int kProducerWarps = 8;
constexpr int kMode3Threads = (kProducerWarps + 1) * kWarp;
constexpr int kMaxBuffers = 4;
constexpr int kTilePad = 3;  // slots after the last buffer: the one-thread chain's loads past a tile
// named barriers (0 is __syncthreads'): a buffer's "full" and "empty"
constexpr int kBarFull = 1;
constexpr int kBarEmpty = kBarFull + kMaxBuffers;

template <typename T> struct Eps;
template <> struct Eps<float> { static __device__ float value() { return 1.1920928955078125e-07f; } };
template <> struct Eps<double> { static __device__ double value() { return 2.220446049250313e-16; } };

// the largest r one thread holds in registers: two r x r arrays
template <typename T> struct ThreadRank;
template <> struct ThreadRank<float> { static constexpr int value = 8; };
template <> struct ThreadRank<double> { static constexpr int value = 5; };

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// named barriers are warp-aligned: the warp meets them converged
__device__ __forceinline__ void bar_sync(int id, int threads) {
  __syncwarp();
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  __syncwarp();
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// --- pinv_rows ----------------------------------------------------------------

template <typename T, int R>
__global__ void __launch_bounds__(kPinvThreads) pinv_rows_thread_kernel(const T* __restrict__ rhs,
                                                                        const T* __restrict__ gram,
                                                                        T* __restrict__ out, int64_t n, T rtol) {
  const int64_t i = (int64_t)blockIdx.x * kPinvThreads + threadIdx.x;
  if (i >= n) return;
  T a[R][R], v[R][R];
  const T* g = gram + i * R * R;
  // the upper triangle defines the symmetric matrix
#pragma unroll
  for (int p = 0; p < R; ++p) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      a[p][q] = p <= q ? g[p * R + q] : g[q * R + p];
      v[p][q] = p == q ? T(1) : T(0);
    }
  }
  const T eps = Eps<T>::value();
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    bool rotated = false;
#pragma unroll
    for (int p = 0; p < R - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < R; ++q) {
        const T apq = a[p][q], app = a[p][p], aqq = a[q][q];
        // negligible against the diagonal (and never a division by a zero apq)
        if (!(fabs(apq) > eps * sqrt(fabs(app)) * sqrt(fabs(aqq)))) continue;
        rotated = true;
        const T theta = (aqq - app) / (T(2) * apq);
        T t = T(1) / (fabs(theta) + hypot(theta, T(1)));
        if (theta < T(0)) t = -t;
        const T c = T(1) / sqrt(T(1) + t * t), s = t * c;
#pragma unroll
        for (int k = 0; k < R; ++k) {
          if (k != p && k != q) {
            const T akp = a[k][p], akq = a[k][q];
            const T np = c * akp - s * akq, nq = s * akp + c * akq;
            a[k][p] = np;
            a[p][k] = np;
            a[k][q] = nq;
            a[q][k] = nq;
          }
          const T vkp = v[k][p], vkq = v[k][q];
          v[k][p] = c * vkp - s * vkq;
          v[k][q] = s * vkp + c * vkq;
        }
        a[p][p] = app - t * apq;
        a[q][q] = aqq + t * apq;
        a[p][q] = T(0);
        a[q][p] = T(0);
      }
    }
    if (!rotated) break;
  }
  T smax = T(0);
#pragma unroll
  for (int k = 0; k < R; ++k) smax = fmax(smax, fabs(a[k][k]));
  const T cut = rtol * smax;
  T b[R], coef[R];
#pragma unroll
  for (int j = 0; j < R; ++j) b[j] = rhs[i * R + j];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const T lam = a[k][k];
    T ck = T(0);
    if (fabs(lam) > cut) {
      T dot = T(0);
#pragma unroll
      for (int j = 0; j < R; ++j) dot += b[j] * v[j][k];
      ck = dot / lam;
    }
    coef[k] = ck;
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < R; ++k) acc += v[j][k] * coef[k];
    out[i * R + j] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarp) pinv_rows_warp_kernel(const T* __restrict__ rhs, const T* __restrict__ gram,
                                                               T* __restrict__ out, int r, T rtol) {
  extern __shared__ unsigned char smem[];
  T* a = reinterpret_cast<T*>(smem);  // the matrix, r x r, row-major
  T* v = a + r * r;                     // its eigenvectors, by columns
  T* coef = v + r * r;                  // (rhs . v_k) / lambda_k, or 0
  const int lane = threadIdx.x;
  const size_t i = blockIdx.x;
  const T* g = gram + i * r * r;
  for (int e = lane; e < r * r; e += kWarp) {
    const int row = e / r, col = e % r;
    a[e] = row <= col ? g[e] : g[col * r + row];
    v[e] = row == col ? T(1) : T(0);
  }
  __syncwarp();
  const T eps = Eps<T>::value();
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    bool rotated = false;  // the same on every lane: each reads the same shared values
    for (int p = 0; p < r - 1; ++p) {
      for (int q = p + 1; q < r; ++q) {
        const T apq = a[p * r + q], app = a[p * r + p], aqq = a[q * r + q];
        __syncwarp();
        if (!(fabs(apq) > eps * sqrt(fabs(app)) * sqrt(fabs(aqq)))) continue;
        rotated = true;
        const T theta = (aqq - app) / (T(2) * apq);
        T t = T(1) / (fabs(theta) + hypot(theta, T(1)));
        if (theta < T(0)) t = -t;
        const T c = T(1) / sqrt(T(1) + t * t), s = t * c;
        if (lane < r) {
          if (lane != p && lane != q) {
            const T akp = a[lane * r + p], akq = a[lane * r + q];
            const T np = c * akp - s * akq, nq = s * akp + c * akq;
            a[lane * r + p] = np;
            a[p * r + lane] = np;
            a[lane * r + q] = nq;
            a[q * r + lane] = nq;
          }
          const T vkp = v[lane * r + p], vkq = v[lane * r + q];
          v[lane * r + p] = c * vkp - s * vkq;
          v[lane * r + q] = s * vkp + c * vkq;
        }
        if (lane == 0) {
          a[p * r + p] = app - t * apq;
          a[q * r + q] = aqq + t * apq;
          a[p * r + q] = T(0);
          a[q * r + p] = T(0);
        }
        __syncwarp();
      }
    }
    if (!rotated) break;
  }
  T smax = T(0);
  for (int k = 0; k < r; ++k) smax = fmax(smax, fabs(a[k * r + k]));
  const T cut = rtol * smax;
  const T* b = rhs + i * r;
  if (lane < r) {
    const T lam = a[lane * r + lane];
    T ck = T(0);
    if (fabs(lam) > cut) {
      T dot = T(0);
      for (int j = 0; j < r; ++j) dot += b[j] * v[j * r + lane];
      ck = dot / lam;
    }
    coef[lane] = ck;
  }
  __syncwarp();
  if (lane < r) {
    T acc = T(0);
    for (int k = 0; k < r; ++k) acc += v[lane * r + k] * coef[k];
    out[i * r + lane] = acc;
  }
}

template <typename T>
using PinvKernel = void (*)(const T*, const T*, T*, int64_t, T);

template <typename T, int R = 1>
PinvKernel<T> pinv_thread_kernel_for(int r) {
  if constexpr (R > ThreadRank<T>::value) {
    return nullptr;
  } else {
    return r == R ? pinv_rows_thread_kernel<T, R> : pinv_thread_kernel_for<T, R + 1>(r);
  }
}

// --- mode3_sweep --------------------------------------------------------------

// a row's slot in a tile buffer: the inverse (r x r, row-major), rhs0 (r),
// padded to 16 bytes
template <typename T>
__host__ __device__ constexpr int slot_stride(int r) {
  return (r * r + r + (16 / (int)sizeof(T)) - 1) / (16 / (int)sizeof(T)) * (16 / (int)sizeof(T));
}

// n elements of T, rounded up to 16 bytes
template <typename T>
__host__ __device__ constexpr int64_t round16(int64_t n) {
  return (n + (16 / (int64_t)sizeof(T)) - 1) / (16 / (int64_t)sizeof(T)) * (16 / (int64_t)sizeof(T));
}

template <typename T>
struct Mode3Args {
  const T* u3;
  const T* rhs_base;
  const T* gram_base;
  T* out;
  int64_t n3, m, m_mod, ntiles;  // m_mod: m mod n3
  T lam1, lam2;
  int r, stride, tile_rows, nbuf;
  int ring_shared;  // the delay line in shared memory (else out's own rows)
  int ring_elems;   // the delay line's elements (the one-thread chain: its staging rows, ring_rows of them)
  int ring_rows;
};

// the diagonal coefficient of row t, as the plain version rounds it
template <typename T>
__device__ __forceinline__ T diag_coef(const Mode3Args<T>& a, int64_t t) {
  const T hp = t > 0 ? T(1) : T(0), hn = t < a.n3 - 1 ? T(1) : T(0);
  const T uf = t < a.n3 - a.m ? T(1) : T(0), ub = t >= a.m ? T(1) : T(0);
  return add_rn(mul_rn(a.lam1, add_rn(hp, hn)), mul_rn(a.lam2, add_rn(uf, ub)));
}

// rhs0[t][j], as the plain version rounds it: the rolls times their flags
template <typename T>
__device__ __forceinline__ T rhs0_at(const Mode3Args<T>& a, int64_t t, int j) {
  const int r = a.r;
  const T hn = t < a.n3 - 1 ? T(1) : T(0), uf = t < a.n3 - a.m ? T(1) : T(0);
  const int64_t next = t + 1 == a.n3 ? 0 : t + 1, fwd = t + a.m_mod < a.n3 ? t + a.m_mod : t + a.m_mod - a.n3;
  const T s = add_rn(a.rhs_base[t * r + j], mul_rn(mul_rn(a.lam1, hn), a.u3[next * r + j]));
  return add_rn(s, mul_rn(mul_rn(a.lam2, uf), a.u3[fwd * r + j]));
}

// row t's inverse by the adjugate (r <= 3) and rhs0, one thread
template <typename T, int R>
__device__ void adjugate_slot(const Mode3Args<T>& a, int64_t t, T* __restrict__ slot) {
  const T d = diag_coef(a, t);
  T mat[R][R];
  const T* g = a.gram_base + t * R * R;
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < R; ++j) mat[i][j] = add_rn(g[i * R + j], mul_rn(d, i == j ? T(1) : T(0)));
  }
  if constexpr (R == 1) {
    slot[0] = div_rn(T(1), mat[0][0]);
  } else if constexpr (R == 2) {
    const T det = sub_rn(mul_rn(mat[0][0], mat[1][1]), mul_rn(mat[0][1], mat[1][0]));
    slot[0] = div_rn(mat[1][1], det);
    slot[1] = div_rn(-mat[0][1], det);
    slot[2] = div_rn(-mat[1][0], det);
    slot[3] = div_rn(mat[0][0], det);
  } else {
    auto cof = [&](int i0, int j0, int i1, int j1, int i2, int j2, int i3, int j3) {
      return sub_rn(mul_rn(mat[i0][j0], mat[i1][j1]), mul_rn(mat[i2][j2], mat[i3][j3]));
    };
    const T det = add_rn(sub_rn(mul_rn(mat[0][0], cof(1, 1, 2, 2, 1, 2, 2, 1)),
                                mul_rn(mat[0][1], cof(1, 0, 2, 2, 1, 2, 2, 0))),
                         mul_rn(mat[0][2], cof(1, 0, 2, 1, 1, 1, 2, 0)));
    const T adj[9] = {cof(1, 1, 2, 2, 1, 2, 2, 1), cof(0, 2, 2, 1, 0, 1, 2, 2), cof(0, 1, 1, 2, 0, 2, 1, 1),
                      cof(1, 2, 2, 0, 1, 0, 2, 2), cof(0, 0, 2, 2, 0, 2, 2, 0), cof(0, 2, 1, 0, 0, 0, 1, 2),
                      cof(1, 0, 2, 1, 1, 1, 2, 0), cof(0, 1, 2, 0, 0, 0, 2, 1), cof(0, 0, 1, 1, 0, 1, 1, 0)};
#pragma unroll
    for (int e = 0; e < 9; ++e) slot[e] = div_rn(adj[e], det);
  }
#pragma unroll
  for (int j = 0; j < R; ++j) slot[R * R + j] = rhs0_at(a, t, j);
}

// row t's inverse by Cholesky (r >= 4) and rhs0, one warp; `low` is the
// warp's r x (r + 1) scratch (the padding column keeps a lane's row off its
// neighbours' banks)
template <typename T>
__device__ void cholesky_slot(const Mode3Args<T>& a, int64_t t, T* __restrict__ slot, T* __restrict__ low,
                              int lane) {
  const int r = a.r, ld = r + 1;
  const T d = diag_coef(a, t);
  const T* g = a.gram_base + t * r * r;
  // the lower triangle, which cholesky_ex reads
  for (int e = lane; e < r * r; e += kWarp) {
    const int i = e / r, j = e % r;
    if (j <= i) low[i * ld + j] = add_rn(g[e], mul_rn(d, i == j ? T(1) : T(0)));
  }
  if (lane < r) slot[r * r + lane] = rhs0_at(a, t, lane);
  __syncwarp();
  bool ok = true;  // the same on every lane
  for (int k = 0; k < r; ++k) {
    const T akk = low[k * ld + k];
    ok = ok && akk > T(0);
    const T piv = sqrt(akk);
    __syncwarp();
    if (lane == k) low[k * ld + k] = piv;
    if (lane > k && lane < r) low[lane * ld + k] /= piv;
    __syncwarp();
    if (lane > k && lane < r) {
      const T lik = low[lane * ld + k];
      for (int j = k + 1; j <= lane; ++j) low[lane * ld + j] -= lik * low[j * ld + k];
    }
    __syncwarp();
  }
  // L^-1 into the slot, a lane a column: y = L^-1 e_j
  T* y = slot;
  if (lane < r) {
    for (int i = 0; i < r; ++i) {
      T s = i == lane ? T(1) : T(0);
      if (i > lane) {
        for (int k = lane; k < i; ++k) s -= low[i * ld + k] * y[k * r + lane];
      }
      y[i * r + lane] = i < lane ? T(0) : s / low[i * ld + i];
    }
  }
  __syncwarp();
  // inv = L^-T L^-1, a lane a column, then over L^-1
  T col[kSofiaMaxRank];
#pragma unroll
  for (int i = 0; i < kSofiaMaxRank; ++i) {
    if (i < r && lane < r) {
      T s = T(0);
      for (int k = i > lane ? i : lane; k < r; ++k) s += y[k * r + i] * y[k * r + lane];
      col[i] = s;
    }
  }
  __syncwarp();
  if (lane < r) {
    const T nan = T(0) / T(0);
#pragma unroll
    for (int i = 0; i < kSofiaMaxRank; ++i) {
      if (i < r) y[i * r + lane] = ok ? col[i] : nan;
    }
  }
}

// producer warp `w`: every tile's systems into the ring of buffers
template <typename T>
__device__ void build_systems(const Mode3Args<T>& a, T* tiles, T* scratch, int w, int lane) {
  const int r = a.r;
  for (int64_t tile = 0; tile < a.ntiles; ++tile) {
    const int b = (int)(tile % a.nbuf);
    if (tile >= a.nbuf) bar_sync(kBarEmpty + b, kMode3Threads);
    T* buf = tiles + (size_t)b * a.tile_rows * a.stride;
    const int64_t first = tile * a.tile_rows;
    if (r <= 3) {
      for (int i = w * kWarp + lane; i < a.tile_rows; i += kProducerWarps * kWarp) {
        const int64_t t = first + i;
        if (t >= a.n3) break;
        T* slot = buf + (size_t)i * a.stride;
        if (r == 1) adjugate_slot<T, 1>(a, t, slot);
        else if (r == 2) adjugate_slot<T, 2>(a, t, slot);
        else adjugate_slot<T, 3>(a, t, slot);
      }
    } else {
      T* low = scratch + (size_t)w * r * (r + 1);
      for (int i = w; i < a.tile_rows && first + i < a.n3; i += kProducerWarps) {
        cholesky_slot(a, first + i, buf + (size_t)i * a.stride, low, lane);
        __syncwarp();
      }
    }
    bar_arrive(kBarFull + b, kMode3Threads);
  }
}

// The chain's walk over the tiles, a row at a time: waits for the next tile
// when the row is its first, after releasing the tile before it, whose rows
// the chain has all loaded by then. Returns the row's slot, counted from the
// first buffer's.
template <typename T>
struct TileWalk {
  const Mode3Args<T>& a;
  int64_t tile = 0;
  int b = 0, row = 0;

  __device__ int first() {
    bar_sync(kBarFull, kMode3Threads);
    return 0;
  }
  __device__ int next() {
    if (++row == a.tile_rows) {
      row = 0;
      if (tile + a.nbuf < a.ntiles) bar_arrive(kBarEmpty + b, kMode3Threads);
      ++tile;
      b = b + 1 == a.nbuf ? 0 : b + 1;
      bar_sync(kBarFull + b, kMode3Threads);
    }
    return b * a.tile_rows + row;
  }
};

// A shared-memory address as a 32-bit register the compiler keeps (it would
// otherwise rebuild it from the CTA's id at each use, a special-register
// read on the chain's issue path), and loads and stores through it, in
// program order with the named barriers.
__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("" : "+r"(s));
  return s;
}
__device__ __forceinline__ void lds16(uint32_t s, float* d) {
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];" : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]) : "r"(s));
}
__device__ __forceinline__ void lds16(uint32_t s, double* d) {
  asm volatile("ld.shared.v2.f64 {%0, %1}, [%2];" : "=d"(d[0]), "=d"(d[1]) : "r"(s));
}
__device__ __forceinline__ void lds(uint32_t s, float& d) { asm volatile("ld.shared.f32 %0, [%1];" : "=f"(d) : "r"(s)); }
__device__ __forceinline__ void lds(uint32_t s, double& d) { asm volatile("ld.shared.f64 %0, [%1];" : "=d"(d) : "r"(s)); }
__device__ __forceinline__ void sts16(uint32_t s, const float* v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(s), "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3]));
}
__device__ __forceinline__ void sts16(uint32_t s, const double* v) {
  asm volatile("st.shared.v2.f64 [%0], {%1, %2};" ::"r"(s), "d"(v[0]), "d"(v[1]));
}

// How the one-thread chain couples row t to row t - m: not at all (m >= n3),
// by row t - 1 (m = 1: one FMA with lam1 + lam2), by a row still in
// registers (m = 2, 3), or by the delay line (m > D), in shared memory or,
// where it does not fit, in out.
enum Coupling { kNone, kPrev, kBack2, kBack3, kRing, kRingOut };

// rows of inputs a one-thread chain keeps in flight, and its register sets
// (one more: a row's loads go into the set its step has no use for)
template <typename T>
__host__ __device__ constexpr int chain_depth(int r) {
  return slot_stride<T>(r) * (int)sizeof(T) <= 96 ? 3 : 2;
}
template <typename T>
__host__ __device__ constexpr int chain_sets(int r) {
  return chain_depth<T>(r) + 1;
}

// The chain in one thread's registers; every lane of warp 0 runs it alike.
// One warp issues in order, one instruction a cycle at best, waits at the
// first use of a result still in flight, and spaces its shared-memory
// accesses, so a row's step is kept to its arithmetic and a few 16-byte
// shared-memory accesses that overlap it:
// - the tiles are walked in an outer loop (tile_rows a multiple of P): its
//   barrier waits and releases, and the copy of its rows out, once a tile;
// - the loads run D rows ahead into P = D + 1 register sets: row t's step
//   first loads row t + D into set (t + D) mod P, which no step now reads,
//   so those loads issue beside row t's arithmetic from set t mod P; the
//   sets are picked at compile time (the loop unrolled by P, whole groups
//   without a test between them: a branch waits for its predicate), so
//   nothing is copied; a tile's first D rows
//   load when it begins, and loads past its end (into the next buffer, or
//   kTilePad padding slots) go unused;
// - each row out goes to a staging ring in shared memory (ring_rows rows, a
//   power of two, padded to 16 bytes), which is also the delay line of the
//   rows m back for m > D; the warp's lanes copy a tile's rows to global
//   memory, coalesced, after its last; the ring starts zeroed, so a row
//   before row 0 reads as 0; where it cannot hold m rows, the rows m back
//   come from out (m > D + tile_rows there: copied by then, before a
//   __syncwarp);
// - the coupling is chosen at compile time (Coupling).
template <typename T, int R, Coupling C>
__device__ void chain_rows(const Mode3Args<T>& a, const T* tiles, T* stage, int lane) {
  constexpr int S = slot_stride<T>(R), V = 16 / sizeof(T), SR = (R + V - 1) / V * V;
  constexpr int D = chain_depth<T>(R), P = chain_sets<T>(R);
  const int n3 = (int)a.n3, m = (int)a.m, mask = a.ring_rows - 1, tile_rows = a.tile_rows;
  const T lam1 = a.lam1, lam2 = a.lam2, lam12 = a.lam1 + a.lam2;
  for (int e = lane; e < a.ring_rows * SR; e += kWarp) stage[e] = T(0);
  __syncwarp();
  const uint32_t tiles_s = shared_addr(tiles), stage_s = shared_addr(stage);
  const uint32_t slot_bytes = a.stride * sizeof(T), row_bytes = SR * sizeof(T);
  T in[P][S], back[P][SR], out[P][R];
#pragma unroll
  for (int k = 0; k < P; ++k) {
#pragma unroll
    for (int j = 0; j < R; ++j) out[k][j] = T(0);
#pragma unroll
    for (int j = 0; j < SR; ++j) back[k][j] = T(0);
  }
  // row u's inputs (its slot at `src`) into set k
  auto load = [&](auto kc, uint32_t src, int u) {
    constexpr int k = decltype(kc)::value;
#pragma unroll
    for (int e = 0; e < S; e += V) lds16(src + e * sizeof(T), &in[k][e]);
    if constexpr (C == kRing) {
#pragma unroll
      for (int e = 0; e < SR; e += V) lds16(stage_s + ((u - m) & mask) * row_bytes + e * sizeof(T), &back[k][e]);
    } else if constexpr (C == kRingOut) {
#pragma unroll
      for (int j = 0; j < R; ++j) back[k][j] = u >= m ? a.out[(int64_t)(u - m) * R + j] : T(0);
    }
  };
  // row t + D (its slot at `ahead`) into set (t + D) mod P, then row t from set k = t mod P
  auto step = [&](auto kc, int t, uint32_t ahead) {
    constexpr int k = decltype(kc)::value;
    load(std::integral_constant<int, (k + D) % P>{}, ahead, t + D);
    const T* prev = out[(k + P - 1) % P];
    T x[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const T rhs = in[k][R * R + j];
      if constexpr (C == kNone) x[j] = fma(lam1, prev[j], rhs);
      else if constexpr (C == kPrev) x[j] = fma(lam12, prev[j], rhs);
      else if constexpr (C == kBack2 || C == kBack3) {
        constexpr int d = C == kBack2 ? 2 : 3;  // out[t - d], 0 before row d
        x[j] = fma(lam1, prev[j], fma(lam2, out[(k + P - d) % P][j], rhs));
      } else {
        x[j] = fma(lam1, prev[j], fma(lam2, back[k][j], rhs));
      }
    }
    T o[SR];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      T acc = x[0] * in[k][j];
#pragma unroll
      for (int c = 1; c < R; ++c) acc = fma(x[c], in[k][c * R + j], acc);
      out[k][j] = o[j] = acc;
    }
#pragma unroll
    for (int j = R; j < SR; ++j) o[j] = T(0);
#pragma unroll
    for (int e = 0; e < SR; e += V) sts16(stage_s + (t & mask) * row_bytes + e * sizeof(T), &o[e]);
  };
  const int ntiles = (int)a.ntiles;
  int b = 0;
  for (int tile = 0; tile < ntiles; ++tile) {
    if (tile > 0) {
      if (tile - 1 + a.nbuf < ntiles) bar_arrive(kBarEmpty + b, kMode3Threads);
      b = b + 1 == a.nbuf ? 0 : b + 1;
    }
    bar_sync(kBarFull + b, kMode3Threads);
    const int t0 = tile * tile_rows, rows = min(tile_rows, n3 - t0);
    const uint32_t src = tiles_s + b * tile_rows * slot_bytes;
    load(std::integral_constant<int, 0>{}, src, t0);
    load(std::integral_constant<int, 1>{}, src + slot_bytes, t0 + 1);
    if constexpr (D == 3) load(std::integral_constant<int, 2>{}, src + 2 * slot_bytes, t0 + 2);
    uint32_t ahead = src + D * slot_bytes;  // row i + D's slot
    int i = 0;
    for (; i + P <= rows; i += P, ahead += P * slot_bytes) {
      step(std::integral_constant<int, 0>{}, t0 + i, ahead);
      step(std::integral_constant<int, 1>{}, t0 + i + 1, ahead + slot_bytes);
      step(std::integral_constant<int, 2>{}, t0 + i + 2, ahead + 2 * slot_bytes);
      if constexpr (P == 4) step(std::integral_constant<int, 3>{}, t0 + i + 3, ahead + 3 * slot_bytes);
    }
    if (i < rows) step(std::integral_constant<int, 0>{}, t0 + i, ahead);
    if (i + 1 < rows) step(std::integral_constant<int, 1>{}, t0 + i + 1, ahead + slot_bytes);
    if constexpr (P == 4) {
      if (i + 2 < rows) step(std::integral_constant<int, 2>{}, t0 + i + 2, ahead + 2 * slot_bytes);
    }
    // the tile's rows out, a lane an element of each kWarp
    T* dst = a.out + (int64_t)t0 * R;
    for (int f = lane; f < rows * R; f += kWarp) {
      const int row = f / R, col = f - row * R;
      T v;
      lds(stage_s + ((t0 + row) & mask) * row_bytes + col * sizeof(T), v);
      dst[f] = v;
    }
    __syncwarp();
  }
}

template <typename T, int R>
__device__ void chain_thread(const Mode3Args<T>& a, const T* tiles, T* stage, int lane) {
  constexpr int D = chain_depth<T>(R);
  const int64_t n3 = a.n3, m = a.m;
  if (m >= n3) {
    chain_rows<T, R, kNone>(a, tiles, stage, lane);
  } else if (m == 1) {
    chain_rows<T, R, kPrev>(a, tiles, stage, lane);
  } else if (m == 2) {
    chain_rows<T, R, kBack2>(a, tiles, stage, lane);
  } else if (m <= D) {
    if constexpr (D == 3) chain_rows<T, R, kBack3>(a, tiles, stage, lane);
  } else if (a.ring_shared) {
    chain_rows<T, R, kRing>(a, tiles, stage, lane);
  } else {
    chain_rows<T, R, kRingOut>(a, tiles, stage, lane);
  }
}

// the chain, a lane a column (r > ThreadRank)
template <typename T>
__device__ void chain_warp(const Mode3Args<T>& a, const T* tiles, T* ring, int lane) {
  const int r = a.r;
  const int64_t n3 = a.n3, m = a.m;
  const bool m1 = m == 1, delayed = m >= 2 && m < n3, mine = lane < r;
  const T lam1 = a.lam1, lam2 = a.lam2, lam12 = a.lam1 + a.lam2;
  TileWalk<T> walk{a};
  T cur[kSofiaMaxRank], nxt[kSofiaMaxRank];
  T cur_rhs = T(0), nxt_rhs = T(0), prev = T(0), back = T(0), back_next = T(0);
  auto load = [&](const T* src, T(&dst)[kSofiaMaxRank], T& rhs) {
#pragma unroll
    for (int k = 0; k < kSofiaMaxRank; ++k) dst[k] = mine && k < r ? src[k * r + lane] : T(0);
    rhs = mine ? src[r * r + lane] : T(0);
  };
  load(tiles + (size_t)walk.first() * a.stride, cur, cur_rhs);
  int64_t slot = 0;
  for (int64_t t = 0; t < n3; ++t) {
    const int64_t read = slot + 1 == m ? 0 : slot + 1;
    if (t + 1 < n3) {
      load(tiles + (size_t)walk.next() * a.stride, nxt, nxt_rhs);
      back_next = T(0);
      if (delayed && t + 1 >= m && mine) {
        if (a.ring_shared) back_next = ring[read * r + lane];
        else back_next = a.out[(t + 1 - m) * r + lane];
      }
    }
    const T x = m1 ? fma(lam12, prev, cur_rhs) : fma(lam1, prev, fma(lam2, back, cur_rhs));
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < kSofiaMaxRank; ++k) {
      if (k < r) acc = fma(__shfl_sync(kFull, x, k), cur[k], acc);
    }
    prev = mine ? acc : T(0);
    if (mine) {
      a.out[t * r + lane] = acc;
      if (delayed && a.ring_shared) ring[slot * r + lane] = acc;
    }
#pragma unroll
    for (int k = 0; k < kSofiaMaxRank; ++k) cur[k] = nxt[k];
    cur_rhs = nxt_rhs;
    back = back_next;
    slot = read;
  }
}

// R > 0: the one-thread chain for that r; R == 0: the warp chain
template <typename T, int R>
__global__ void __launch_bounds__(kMode3Threads, 1) mode3_sweep_kernel(const Mode3Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);
  T* ring = tiles + ((size_t)a.nbuf * a.tile_rows + kTilePad) * a.stride;
  T* scratch = ring + a.ring_elems;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  if (warp > 0) {
    build_systems(a, tiles, scratch, warp - 1, lane);
  } else if constexpr (R > 0) {
    chain_thread<T, R>(a, tiles, ring, lane);
  } else {
    chain_warp(a, tiles, ring, lane);
  }
}

template <typename T>
using Mode3Kernel = void (*)(const Mode3Args<T>);

template <typename T, int R = 1>
Mode3Kernel<T> mode3_kernel_for(int r) {
  if constexpr (R > ThreadRank<T>::value) {
    return mode3_sweep_kernel<T, 0>;
  } else {
    return r == R ? mode3_sweep_kernel<T, R> : mode3_kernel_for<T, R + 1>(r);
  }
}

template <typename T>
int pinv_rows(const T* rhs, const T* gram, T* out, int64_t n, int r, T rtol, void* stream) {
  if (r < 1 || r > kSofiaMaxRank || n < 0 || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (PinvKernel<T> k = pinv_thread_kernel_for<T>(r)) {
    k<<<(unsigned)((n + kPinvThreads - 1) / kPinvThreads), kPinvThreads, 0, s>>>(rhs, gram, out, n, rtol);
  } else {
    const size_t shared = (2 * (size_t)r * r + r) * sizeof(T);
    pinv_rows_warp_kernel<T><<<(unsigned)n, kWarp, shared, s>>>(rhs, gram, out, r, rtol);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int mode3_sweep(const T* u3, const T* rhs_base, const T* gram_base, T* out, int64_t n3, int r, T lam1, T lam2,
                int64_t m, void* stream) {
  if (r < 1 || r > kSofiaMaxRank || n3 < 0 || m < 1) return (int)cudaErrorInvalidValue;
  if (n3 == 0) return 0;
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  Mode3Args<T> a{u3, rhs_base, gram_base, out, n3, m, m % n3, 0, lam1, lam2, r, slot_stride<T>(r), 0, 0, 0, 0, 0};
  const size_t slot = a.stride * sizeof(T);
  // the warp scratch of the Cholesky rows; the delay line: for the one-thread
  // chain its staging ring of rows out (16-byte rows, a power of two of
  // them, at least a tile's and, for m > D, m), for the warp chain m rows
  const size_t scratch = r >= 4 ? kProducerWarps * (size_t)r * (r + 1) * sizeof(T) : 0;
  const bool one_thread = r <= ThreadRank<T>::value, delayed = m >= 2 && m < n3;
  const int depth = one_thread ? chain_sets<T>(r) : 1;
  if (one_thread && n3 > 0x40000000LL) return (int)cudaErrorInvalidValue;  // its rows are counted in int
  auto pow2 = [](int64_t n) {
    int64_t p = 1;
    while (p < n) p *= 2;
    return p;
  };
  // a tile: a row a producer thread for r <= 3, else a few rows a producer
  // warp; a multiple of the one-thread chain's register sets
  const int tiles[] = {r <= 3 ? kProducerWarps * kWarp : 4 * kProducerWarps, 2 * kProducerWarps, kProducerWarps};
  size_t shared = 0;
  for (int with_ring = 1; with_ring >= 0 && !a.nbuf; --with_ring) {
    for (int tile : tiles) {
      const int rows = tile / depth * depth;
      const int64_t staged = pow2(std::max<int64_t>(with_ring && delayed ? m : 0, rows));
      const int64_t elems = one_thread ? staged * round16<T>(r) : (with_ring && delayed ? round16<T>(m * r) : 0);
      for (int nbuf = kMaxBuffers; nbuf >= 2 && !a.nbuf; --nbuf) {
        const size_t need = (nbuf * rows + kTilePad) * slot + scratch + elems * sizeof(T);
        if (need <= (size_t)optin) {
          a.tile_rows = rows;
          a.nbuf = nbuf;
          a.ring_shared = with_ring;
          a.ring_elems = (int)elems;
          a.ring_rows = one_thread ? (int)staged : 0;
          shared = need;
        }
      }
      if (a.nbuf) break;
    }
  }
  // without the delay line the one-thread chain reads a row m back from out once a tile's copy wrote it
  if (!a.nbuf || (!a.ring_shared && one_thread && m <= 3 + a.tile_rows)) return (int)cudaErrorInvalidValue;
  a.ntiles = (n3 + a.tile_rows - 1) / a.tile_rows;
  const Mode3Kernel<T> kernel = mode3_kernel_for<T>(r);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, kMode3Threads, shared, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
__global__ void __launch_bounds__(kWarp) gauss_seidel_sweep_kernel(const T* __restrict__ rhs0,
                                                                   const T* __restrict__ inv, T* out, int64_t n3,
                                                                   int r, T lam1, T lam2, int64_t m) {
  const int lane = threadIdx.x;
  const bool mine = lane < r;
  T prev = T(0);
  for (int64_t t = 0; t < n3; ++t) {
    T x = mine ? rhs0[t * r + lane] : T(0);
    if (t > 0) x += lam1 * prev;
    // row t - m was written by this lane, so it reads its own store
    if (t >= m && mine) x += lam2 * out[(t - m) * r + lane];
    const T* it = inv + t * r * r;
    T acc = T(0);
    for (int k = 0; k < r; ++k) {
      const T xk = __shfl_sync(kFull, x, k);
      if (mine) acc += xk * it[k * r + lane];
    }
    if (mine) out[t * r + lane] = acc;
    prev = acc;
  }
}

template <typename T>
int gauss_seidel_sweep(const T* rhs0, const T* inv, T* out, int64_t n3, int r, T lam1, T lam2, int64_t m,
                       void* stream) {
  if (r < 1 || r > kSofiaMaxRank || n3 < 0 || m < 1) return (int)cudaErrorInvalidValue;
  if (n3 == 0) return 0;
  gauss_seidel_sweep_kernel<T><<<1, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(rhs0, inv, out, n3, r, lam1,
                                                                                    lam2, m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tritd_sofia_max_rank(void) { return kSofiaMaxRank; }

int tritd_pinv_rows_f32(const float* rhs, const float* gram, float* out, int64_t n, int r, float rtol,
                        void* stream) {
  return pinv_rows<float>(rhs, gram, out, n, r, rtol, stream);
}
int tritd_pinv_rows_f64(const double* rhs, const double* gram, double* out, int64_t n, int r, double rtol,
                        void* stream) {
  return pinv_rows<double>(rhs, gram, out, n, r, rtol, stream);
}

int tritd_mode3_sweep_f32(const float* u3, const float* rhs_base, const float* gram_base, float* out, int64_t n3,
                          int r, float lam1, float lam2, int64_t m, void* stream) {
  return mode3_sweep<float>(u3, rhs_base, gram_base, out, n3, r, lam1, lam2, m, stream);
}
int tritd_mode3_sweep_f64(const double* u3, const double* rhs_base, const double* gram_base, double* out,
                          int64_t n3, int r, double lam1, double lam2, int64_t m, void* stream) {
  return mode3_sweep<double>(u3, rhs_base, gram_base, out, n3, r, lam1, lam2, m, stream);
}

int tritd_gauss_seidel_sweep_f32(const float* rhs0, const float* inv, float* out, int64_t n3, int r, float lam1,
                                 float lam2, int64_t m, void* stream) {
  return gauss_seidel_sweep<float>(rhs0, inv, out, n3, r, lam1, lam2, m, stream);
}
int tritd_gauss_seidel_sweep_f64(const double* rhs0, const double* inv, double* out, int64_t n3, int r,
                                 double lam1, double lam2, int64_t m, void* stream) {
  return gauss_seidel_sweep<double>(rhs0, inv, out, n3, r, lam1, lam2, m, stream);
}

}  // extern "C"
