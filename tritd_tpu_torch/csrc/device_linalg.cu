// cuSOLVER's dense symmetric eigensolvers and SVDs behind a plain C
// interface, for ops/device_linalg.py. No Pallas kernel stands behind them:
// the reference's `jnp.linalg.eigh` and `jnp.linalg.svd` (tritd_tpu/ops/
// svt.py, ops/decomp.py) are XLA library calls, which XLA lowers to cuSOLVER
// on a GPU. torch.linalg.eigh and torch.linalg.svd call the same drivers but
// read cuSOLVER's `info` back to the host after every call, which a CUDA
// graph capture refuses. These entry points leave `info` on the device,
// unread, as the reference does: a failed factorization shows as NaN.
//
// Every entry point takes a handle (one a device, made by
// tritd_linalg_create), sets the handle's stream to the caller's stream and
// returns cuSOLVER's status (0 on success). The caller allocates every
// buffer: the matrix (overwritten), the outputs, the device workspace (its
// size from the matching *_buffer entry), a host workspace where the 64-bit
// API asks for one, and `info` (one int on the device). Matrices are
// column-major, as cuSOLVER takes them; the Python side passes the
// transpose of a row-major tensor where it needs to. `dt` is 0 for float32,
// 1 for float64.
//
// Drivers: XsyevBatched (a batch of one) up to n = 512 and Xsyevd (divide
// and conquer, torch.linalg.eigh's) past it for the eigenproblem,
// {S,D}gesvdj (Jacobi, torch.linalg.svd's) for the thin SVD, its tolerance
// and sweep count from a gesvdjInfo_t made by tritd_gesvdj_info_create (a
// tolerance or sweep count of 0 keeps cuSOLVER's default). Of these only
// XsyevBatched at n <= 512 can be captured in a CUDA graph; the others read
// back to the host inside the call (`python -m
// tritd_tpu_torch.tools.capture_linalg`, whose tools/capture_probe.cu tries
// the drivers this file leaves out).

#include <cuda_runtime.h>
#include <cusolverDn.h>
#include <dlfcn.h>

#include <cstdint>
#include <cstring>

namespace {

cudaDataType type_of(int dt) { return dt ? CUDA_R_64F : CUDA_R_32F; }

cusolverDnHandle_t H(void* h) { return static_cast<cusolverDnHandle_t>(h); }
cusolverDnParams_t P(void* p) { return static_cast<cusolverDnParams_t>(p); }

constexpr cusolverEigMode_t kVectors = CUSOLVER_EIG_MODE_VECTOR;
constexpr cublasFillMode_t kLower = CUBLAS_FILL_MODE_LOWER;

}  // namespace

extern "C" {

int tritd_linalg_version(void) {
  int v = 0;
  cusolverGetVersion(&v);
  return v;
}

// The file that serves the cuSOLVER calls of this library (dladdr of one of
// its functions): a process that loaded another libcusolver of the same
// soname first resolves to that one.
int tritd_linalg_provider(char* buf, int len) {
  Dl_info info;
  if (!dladdr(reinterpret_cast<void*>(&cusolverDnXsyevd), &info) || !info.dli_fname) return 1;
  std::strncpy(buf, info.dli_fname, len - 1);
  buf[len - 1] = '\0';
  return 0;
}

int tritd_linalg_create(void** handle, void** params) {
  cusolverDnHandle_t h;
  cusolverStatus_t st = cusolverDnCreate(&h);
  if (st != CUSOLVER_STATUS_SUCCESS) return st;
  cusolverDnParams_t p;
  st = cusolverDnCreateParams(&p);
  if (st != CUSOLVER_STATUS_SUCCESS) {
    cusolverDnDestroy(h);
    return st;
  }
  *handle = h;
  *params = p;
  return 0;
}

int tritd_gesvdj_info_create(void** out, double tol, int max_sweeps) {
  gesvdjInfo_t info;
  cusolverStatus_t st = cusolverDnCreateGesvdjInfo(&info);
  if (st != CUSOLVER_STATUS_SUCCESS) return st;
  if (tol > 0) st = cusolverDnXgesvdjSetTolerance(info, tol);
  if (st == CUSOLVER_STATUS_SUCCESS && max_sweeps > 0) st = cusolverDnXgesvdjSetMaxSweeps(info, max_sweeps);
  if (st != CUSOLVER_STATUS_SUCCESS) {
    cusolverDnDestroyGesvdjInfo(info);
    return st;
  }
  *out = info;
  return 0;
}

// ---- eigh: Xsyevd, the lower triangle of the n x n column-major a ----

int tritd_xsyevd_buffer(void* h, void* p, int dt, int64_t n, void* a, void* w, size_t* dev_bytes,
                        size_t* host_bytes) {
  cudaDataType t = type_of(dt);
  return cusolverDnXsyevd_bufferSize(H(h), P(p), kVectors, kLower, n, t, a, n, t, w, t, dev_bytes, host_bytes);
}

int tritd_xsyevd(void* h, void* p, int dt, int64_t n, void* a, void* w, void* work, size_t dev_bytes,
                 void* host_work, size_t host_bytes, void* info, void* stream) {
  cusolverStatus_t st = cusolverDnSetStream(H(h), static_cast<cudaStream_t>(stream));
  if (st != CUSOLVER_STATUS_SUCCESS) return st;
  cudaDataType t = type_of(dt);
  return cusolverDnXsyevd(H(h), P(p), kVectors, kLower, n, t, a, n, t, w, t, work, dev_bytes, host_work,
                          host_bytes, static_cast<int*>(info));
}

// ---- eigh: XsyevBatched with a batch of one: the one cuSOLVER eigensolver
// that a stream capture takes (n <= 512 on cuSOLVER 11.7) ----

int tritd_xsyevbatched_buffer(void* h, void* p, int dt, int64_t n, void* a, void* w, size_t* dev_bytes,
                              size_t* host_bytes) {
  cudaDataType t = type_of(dt);
  return cusolverDnXsyevBatched_bufferSize(H(h), P(p), kVectors, kLower, n, t, a, n, t, w, t, dev_bytes, host_bytes,
                                           1);
}

int tritd_xsyevbatched(void* h, void* p, int dt, int64_t n, void* a, void* w, void* work, size_t dev_bytes,
                       void* host_work, size_t host_bytes, void* info, void* stream) {
  cusolverStatus_t st = cusolverDnSetStream(H(h), static_cast<cudaStream_t>(stream));
  if (st != CUSOLVER_STATUS_SUCCESS) return st;
  cudaDataType t = type_of(dt);
  return cusolverDnXsyevBatched(H(h), P(p), kVectors, kLower, n, t, a, n, t, w, t, work, dev_bytes, host_work,
                                host_bytes, static_cast<int*>(info), 1);
}

// ---- svd: {S,D}gesvdj, economy size, of the m x n column-major a; U (m x k), V (n x k) ----

int tritd_gesvdj_buffer(void* h, void* j, int dt, int m, int n, void* a, void* s, void* u, void* v, int* lwork) {
  gesvdjInfo_t info = static_cast<gesvdjInfo_t>(j);
  if (dt)
    return cusolverDnDgesvdj_bufferSize(H(h), kVectors, 1, m, n, static_cast<double*>(a), m, static_cast<double*>(s),
                                        static_cast<double*>(u), m, static_cast<double*>(v), n, lwork, info);
  return cusolverDnSgesvdj_bufferSize(H(h), kVectors, 1, m, n, static_cast<float*>(a), m, static_cast<float*>(s),
                                      static_cast<float*>(u), m, static_cast<float*>(v), n, lwork, info);
}

int tritd_gesvdj(void* h, void* j, int dt, int m, int n, void* a, void* s, void* u, void* v, void* work, int lwork,
                 void* info, void* stream) {
  cusolverStatus_t st = cusolverDnSetStream(H(h), static_cast<cudaStream_t>(stream));
  if (st != CUSOLVER_STATUS_SUCCESS) return st;
  gesvdjInfo_t params = static_cast<gesvdjInfo_t>(j);
  if (dt)
    return cusolverDnDgesvdj(H(h), kVectors, 1, m, n, static_cast<double*>(a), m, static_cast<double*>(s),
                             static_cast<double*>(u), m, static_cast<double*>(v), n, static_cast<double*>(work), lwork,
                             static_cast<int*>(info), params);
  return cusolverDnSgesvdj(H(h), kVectors, 1, m, n, static_cast<float*>(a), m, static_cast<float*>(s),
                           static_cast<float*>(u), m, static_cast<float*>(v), n, static_cast<float*>(work), lwork,
                           static_cast<int*>(info), params);
}

}  // extern "C"

