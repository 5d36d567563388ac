// Which cuSOLVER drivers a CUDA stream capture takes, without torch: one driver at one size a process
// (python -m tritd_tpu_torch.tools.capture_linalg builds and runs it), the drivers csrc/device_linalg.cu carries
// beside those it leaves out. Usage: capture_probe DRIVER DT M N (DT 0 float, 1 double; the eigen drivers take N,
// XsyevBatched M as its batch). Prints one JSON line: workspace bytes, the eager call's status, info and µs, the
// capture's statuses, whether a replay gives the eager call's bits, and its µs.
#include <cuda_runtime.h>
#include <cusolverDn.h>

#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <string>
#include <vector>

#define T(dt) ((dt) ? CUDA_R_64F : CUDA_R_32F)

struct Out { void* p; size_t bytes; };

int main(int argc, char** argv) {
  std::string drv = argv[1];
  int dt = atoi(argv[2]);
  int64_t m = atoll(argv[3]), n = atoll(argv[4]);
  size_t es = dt ? 8 : 4;
  bool eig = drv == "xsyevd" || drv == "syevj" || drv == "xsyevbatched" || drv == "sytrd" || drv == "sytrd_orgtr" ||
             drv == "xsyevdx";
  int64_t batch = drv == "xsyevbatched" ? m : 1;
  if (eig) m = n;
  int64_t k = m < n ? m : n;
  // the input: a Gram of an n x 2n normal matrix for the eigen drivers, a normal m x n matrix for the SVDs
  std::mt19937_64 rng(1234);
  std::normal_distribution<double> nd;
  std::vector<double> a0(m * n);
  if (eig) {
    std::vector<double> g(n * 2 * n);
    for (auto& x : g) x = nd(rng);
    for (int64_t i = 0; i < n; ++i)
      for (int64_t j = 0; j < n; ++j) {
        double s = 0;
        for (int64_t l = 0; l < 2 * n; ++l) s += g[i * 2 * n + l] * g[j * 2 * n + l];
        a0[i + j * n] = s;
      }
  } else {
    for (auto& x : a0) x = nd(rng);
  }
  std::vector<char> host(m * n * es);
  for (int64_t i = 0; i < m * n; ++i) {
    if (dt) ((double*)host.data())[i] = a0[i]; else ((float*)host.data())[i] = (float)a0[i];
  }
  cusolverDnHandle_t h;
  cusolverDnCreate(&h);
  cusolverDnParams_t params;
  cusolverDnCreateParams(&params);
  syevjInfo_t sj;
  cusolverDnCreateSyevjInfo(&sj);
  gesvdjInfo_t gj;
  cusolverDnCreateGesvdjInfo(&gj);
  cudaStream_t st;
  cudaStreamCreateWithFlags(&st, cudaStreamNonBlocking);
  cusolverDnSetStream(h, st);
  void *A0, *A, *W, *U, *V, *E, *tau, *work = nullptr;
  int* info;
  cudaMalloc(&A0, batch * m * n * es);
  cudaMalloc(&A, batch * m * n * es);
  cudaMalloc(&W, batch * (k + 1) * es);
  cudaMalloc(&U, m * k * es + es);
  cudaMalloc(&V, n * k * es + es);
  cudaMalloc(&E, (n + 1) * es);
  cudaMalloc(&tau, (n + 1) * es);
  cudaMalloc(&info, sizeof(int) * batch);
  for (int64_t b = 0; b < batch; ++b) cudaMemcpy((char*)A0 + b * m * n * es, host.data(), m * n * es, cudaMemcpyHostToDevice);
  size_t dev = 0, hb = 0;
  int lwork = 0, lwork2 = 0;
  cusolverEigMode_t jv = CUSOLVER_EIG_MODE_VECTOR;
  cublasFillMode_t lo = CUBLAS_FILL_MODE_LOWER;
  int64_t meig = 0;
  double herr = 0, vl = 0, vu = 0;
  int bst = 0;
  if (drv == "xsyevd") bst = cusolverDnXsyevd_bufferSize(h, params, jv, lo, n, T(dt), A, n, T(dt), W, T(dt), &dev, &hb);
  else if (drv == "xsyevdx") bst = cusolverDnXsyevdx_bufferSize(h, params, jv, CUSOLVER_EIG_RANGE_ALL, lo, n, T(dt), A, n, &vl, &vu, 0, 0, &meig, T(dt), W, T(dt), &dev, &hb);
#if CUSOLVER_VERSION >= 11604
  else if (drv == "xsyevbatched") bst = cusolverDnXsyevBatched_bufferSize(h, params, jv, lo, n, T(dt), A, n, T(dt), W, T(dt), &dev, &hb, batch);
#endif
  else if (drv == "syevj") bst = dt ? cusolverDnDsyevj_bufferSize(h, jv, lo, n, (double*)A, n, (double*)W, &lwork, sj) : cusolverDnSsyevj_bufferSize(h, jv, lo, n, (float*)A, n, (float*)W, &lwork, sj);
  else if (drv == "sytrd" || drv == "sytrd_orgtr") {
    bst = dt ? cusolverDnDsytrd_bufferSize(h, lo, n, (double*)A, n, (double*)W, (double*)E, (double*)tau, &lwork) : cusolverDnSsytrd_bufferSize(h, lo, n, (float*)A, n, (float*)W, (float*)E, (float*)tau, &lwork);
    if (drv == "sytrd_orgtr") {
      if (dt) cusolverDnDorgtr_bufferSize(h, lo, n, (double*)A, n, (double*)tau, &lwork2); else cusolverDnSorgtr_bufferSize(h, lo, n, (float*)A, n, (float*)tau, &lwork2);
      if (lwork2 > lwork) lwork = lwork2;
    }
  }
  else if (drv == "xgesvd") bst = cusolverDnXgesvd_bufferSize(h, params, 'S', 'S', m, n, T(dt), A, m, T(dt), W, T(dt), U, m, T(dt), V, k, T(dt), &dev, &hb);
  else if (drv == "gesvdj") bst = dt ? cusolverDnDgesvdj_bufferSize(h, jv, 1, m, n, (double*)A, m, (double*)W, (double*)U, m, (double*)V, n, &lwork, gj) : cusolverDnSgesvdj_bufferSize(h, jv, 1, m, n, (float*)A, m, (float*)W, (float*)U, m, (float*)V, n, &lwork, gj);
  else if (drv == "gesvda") bst = dt ? cusolverDnDgesvdaStridedBatched_bufferSize(h, jv, (int)k, m, n, (double*)A, m, m * n, (double*)W, k, (double*)U, m, m * k, (double*)V, n, n * k, &lwork, 1) : cusolverDnSgesvdaStridedBatched_bufferSize(h, jv, (int)k, m, n, (float*)A, m, m * n, (float*)W, k, (float*)U, m, m * k, (float*)V, n, n * k, &lwork, 1);
  else if (drv == "xgesvdp") bst = cusolverDnXgesvdp_bufferSize(h, params, jv, 1, m, n, T(dt), A, m, T(dt), W, T(dt), U, m, T(dt), V, n, T(dt), &dev, &hb);
  else { printf("{\"driver\": \"%s\", \"error\": \"unknown\"}\n", drv.c_str()); return 1; }
  if (lwork) dev = (size_t)lwork * es;
  cudaMalloc(&work, dev + 16);
  std::vector<char> hwork(hb + 16);
  auto run = [&]() -> int {
    cudaMemcpyAsync(A, A0, batch * m * n * es, cudaMemcpyDeviceToDevice, st);
    if (drv == "xsyevd") return cusolverDnXsyevd(h, params, jv, lo, n, T(dt), A, n, T(dt), W, T(dt), work, dev, hwork.data(), hb, info);
    if (drv == "xsyevdx") return cusolverDnXsyevdx(h, params, jv, CUSOLVER_EIG_RANGE_ALL, lo, n, T(dt), A, n, &vl, &vu, 0, 0, &meig, T(dt), W, T(dt), work, dev, hwork.data(), hb, info);
#if CUSOLVER_VERSION >= 11604
    if (drv == "xsyevbatched") return cusolverDnXsyevBatched(h, params, jv, lo, n, T(dt), A, n, T(dt), W, T(dt), work, dev, hwork.data(), hb, info, batch);
#endif
    if (drv == "syevj") return dt ? cusolverDnDsyevj(h, jv, lo, n, (double*)A, n, (double*)W, (double*)work, lwork, info, sj) : cusolverDnSsyevj(h, jv, lo, n, (float*)A, n, (float*)W, (float*)work, lwork, info, sj);
    if (drv == "sytrd" || drv == "sytrd_orgtr") {
      int s = dt ? cusolverDnDsytrd(h, lo, n, (double*)A, n, (double*)W, (double*)E, (double*)tau, (double*)work, lwork, info) : cusolverDnSsytrd(h, lo, n, (float*)A, n, (float*)W, (float*)E, (float*)tau, (float*)work, lwork, info);
      if (s || drv == "sytrd") return s;
      return dt ? cusolverDnDorgtr(h, lo, n, (double*)A, n, (double*)tau, (double*)work, lwork, info) : cusolverDnSorgtr(h, lo, n, (float*)A, n, (float*)tau, (float*)work, lwork, info);
    }
    if (drv == "xgesvd") return cusolverDnXgesvd(h, params, 'S', 'S', m, n, T(dt), A, m, T(dt), W, T(dt), U, m, T(dt), V, k, T(dt), work, dev, hwork.data(), hb, info);
    if (drv == "gesvdj") return dt ? cusolverDnDgesvdj(h, jv, 1, m, n, (double*)A, m, (double*)W, (double*)U, m, (double*)V, n, (double*)work, lwork, info, gj) : cusolverDnSgesvdj(h, jv, 1, m, n, (float*)A, m, (float*)W, (float*)U, m, (float*)V, n, (float*)work, lwork, info, gj);
    if (drv == "gesvda") return dt ? cusolverDnDgesvdaStridedBatched(h, jv, (int)k, m, n, (double*)A, m, m * n, (double*)W, k, (double*)U, m, m * k, (double*)V, n, n * k, (double*)work, lwork, info, nullptr, 1) : cusolverDnSgesvdaStridedBatched(h, jv, (int)k, m, n, (float*)A, m, m * n, (float*)W, k, (float*)U, m, m * k, (float*)V, n, n * k, (float*)work, lwork, info, nullptr, 1);
    if (drv == "xgesvdp") return cusolverDnXgesvdp(h, params, jv, 1, m, n, T(dt), A, m, T(dt), W, T(dt), U, m, T(dt), V, n, T(dt), work, dev, hwork.data(), hb, info, &herr);
    return -1;
  };
  std::vector<Out> outs = {{A, (size_t)(m * n) * es}, {W, (size_t)k * es}};
  if (!eig) { outs.push_back({U, (size_t)(m * k) * es}); outs.push_back({V, (size_t)(n * k) * es}); }
  if (drv.rfind("sytrd", 0) == 0) { outs.push_back({E, (size_t)(n - 1) * es}); outs.push_back({tau, (size_t)(n - 1) * es}); }
  auto fetch = [&]() {
    std::vector<std::vector<char>> r;
    for (auto& o : outs) { r.emplace_back(o.bytes); cudaMemcpy(r.back().data(), o.p, o.bytes, cudaMemcpyDeviceToHost); }
    return r;
  };
  int est = run();
  cudaError_t esync = cudaStreamSynchronize(st);
  int hinfo = -99;
  cudaMemcpy(&hinfo, info, sizeof(int), cudaMemcpyDeviceToHost);
  auto eager = fetch();
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0); cudaEventCreate(&e1);
  cudaEventRecord(e0, st);
  for (int i = 0; i < 5; ++i) run();
  cudaEventRecord(e1, st);
  cudaEventSynchronize(e1);
  float eager_ms = 0;
  cudaEventElapsedTime(&eager_ms, e0, e1);
  // capture
  cudaGraph_t g = nullptr;
  cudaGraphExec_t ge = nullptr;
  cudaError_t beg = cudaStreamBeginCapture(st, cudaStreamCaptureModeGlobal);
  int cst = run();
  cudaError_t endc = cudaStreamEndCapture(st, &g);
  cudaError_t inst = cudaErrorUnknown, launch = cudaErrorUnknown;
  int bitwise = -1;
  float replay_ms = -1;
  if (endc == cudaSuccess && cst == 0) {
    inst = cudaGraphInstantiate(&ge, g, 0);
    if (inst == cudaSuccess) {
      launch = cudaGraphLaunch(ge, st);
      cudaStreamSynchronize(st);
      auto r = fetch();
      bitwise = 1;
      for (size_t i = 0; i < r.size(); ++i) if (memcmp(r[i].data(), eager[i].data(), r[i].size())) bitwise = 0;
      cudaEventRecord(e0, st);
      for (int i = 0; i < 5; ++i) cudaGraphLaunch(ge, st);
      cudaEventRecord(e1, st);
      cudaEventSynchronize(e1);
      cudaEventElapsedTime(&replay_ms, e0, e1);
    }
  }
  cudaGetLastError();
  int after = run();
  cudaError_t async = cudaStreamSynchronize(st);
  printf("{\"driver\": \"%s\", \"batch\": %lld, \"dtype\": \"%s\", \"m\": %lld, \"n\": %lld, \"buffer_status\": %d, \"device_bytes\": %zu, "
         "\"host_bytes\": %zu, \"eager_status\": %d, \"eager_sync\": \"%s\", \"info\": %d, \"eager_us\": %.1f, "
         "\"begin_capture\": \"%s\", \"status_in_capture\": %d, \"end_capture\": \"%s\", \"instantiate\": \"%s\", "
         "\"launch\": \"%s\", \"replay_bitwise\": %d, \"replay_us\": %.1f, \"eager_after_capture\": %d, \"sync_after\": \"%s\"}\n",
         drv.c_str(), (long long)batch, dt ? "float64" : "float32", (long long)m, (long long)n, bst, dev, hb, est, cudaGetErrorString(esync),
         hinfo, eager_ms * 200.0f, cudaGetErrorString(beg), cst, cudaGetErrorString(endc), cudaGetErrorString(inst),
         cudaGetErrorString(launch), bitwise, replay_ms * 200.0f, after, cudaGetErrorString(async));
  return 0;
}
