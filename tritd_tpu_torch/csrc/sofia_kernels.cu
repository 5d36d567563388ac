// SOFIA's two solves inside its masked CP-ALS loop (baselines/sofia.py), as
// kernels that a CUDA graph can hold. Neither replaces a Pallas kernel: the
// reference computes both with jnp inside its device loops,
// `jax.vmap(... jnp.linalg.pinv(g))` (tritd_tpu/baselines/sofia.py:69) and
// the `lax.scan` of the mode-3 Gauss-Seidel sweep (:175). torch's pinv
// checks LAPACK's `info` on the host, so no graph can capture it, and the
// sweep written in torch is about four launches a row.
//
// pinv_rows: out[i] = rhs[i] @ pinv(gram[i]) for n symmetric r x r grams,
// one warp a matrix (r <= 32, a lane a column): cyclic Jacobi on the matrix
// in shared memory, then pinv = V diag(1/lambda where |lambda| > cut) V^T
// with cut = rtol * max|lambda|, which for a symmetric matrix is the SVD
// pseudo-inverse (singular values |lambda|) with torch's rule, S > cut. An
// all-zero gram has cut 0 and keeps no eigenvalue: its row is exactly zero,
// the min-norm answer. Bound: a few hundred dependent flops a rotation and
// a few sweeps; at SOFIA's r = 3 the n = 100..320 warps are latency-bound.
//
// gauss_seidel_sweep: out[t] = (rhs0[t] + lam1 out[t-1] + lam2 out[t-m]) @
// inv[t] for t = 0..n3-1 (the terms with t-1 < 0 or t-m < 0 left out), one
// warp walking the rows in order, lane j holding column j. The chain of n3
// dependent steps bounds it: each step waits for the row before it (a
// shuffle per term of the r-long product) and, at t >= m, for the row m back,
// which the same lane wrote. Made right first; its speed is later work.
//
// Each entry returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for an r outside 1..kSofiaMaxRank; n == 0 launches
// nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSofiaMaxRank = 32;
constexpr int kWarp = 32;
constexpr int kMaxSweeps = 40;
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Eps;
template <> struct Eps<float> { static __device__ float value() { return 1.1920928955078125e-07f; } };
template <> struct Eps<double> { static __device__ double value() { return 2.220446049250313e-16; } };

template <typename T>
__global__ void __launch_bounds__(kWarp) pinv_rows_kernel(const T* __restrict__ rhs, const T* __restrict__ gram,
                                                          T* __restrict__ out, int r, T rtol) {
  extern __shared__ unsigned char smem[];
  T* a = reinterpret_cast<T*>(smem);  // the matrix, r x r, row-major
  T* v = a + r * r;                     // its eigenvectors, by columns
  T* coef = v + r * r;                  // (rhs . v_k) / lambda_k, or 0
  const int lane = threadIdx.x;
  const size_t i = blockIdx.x;
  const T* g = gram + i * r * r;
  // the upper triangle defines the symmetric matrix
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
        // negligible against the diagonal (and never a division by a zero apq)
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
int pinv_rows(const T* rhs, const T* gram, T* out, int64_t n, int r, T rtol, void* stream) {
  if (r < 1 || r > kSofiaMaxRank || n < 0 || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const size_t shared = (2 * (size_t)r * r + r) * sizeof(T);
  pinv_rows_kernel<T><<<(unsigned)n, kWarp, shared, static_cast<cudaStream_t>(stream)>>>(rhs, gram, out, r, rtol);
  return (int)cudaGetLastError();
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

int tritd_gauss_seidel_sweep_f32(const float* rhs0, const float* inv, float* out, int64_t n3, int r, float lam1,
                                 float lam2, int64_t m, void* stream) {
  return gauss_seidel_sweep<float>(rhs0, inv, out, n3, r, lam1, lam2, m, stream);
}
int tritd_gauss_seidel_sweep_f64(const double* rhs0, const double* inv, double* out, int64_t n3, int r,
                                 double lam1, double lam2, int64_t m, void* stream) {
  return gauss_seidel_sweep<double>(rhs0, inv, out, n3, r, lam1, lam2, m, stream);
}

}  // extern "C"
