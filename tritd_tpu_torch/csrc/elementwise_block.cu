// Fused elementwise ADMM block for NVIDIA Hopper (sm_90a).
//
// Replaces: tritd_tpu/ops/pallas_kernels.py::_kernel (launched by
// _block_pallas through pl.pallas_call). Per element, with scalars
// muL, muO, lam and muL_next:
//
//   r1 = D - L + Y_L/muL          O'   = (muL*r1 + muO*r2) / (muL + muO)
//   r2 = E - Y_O/muO              E'   = soft(O' + Y_O/muO, lam/muO)
//   res_l = D - L - O'            Y_L' = Y_L + muL*res_l
//   res_o = O' - E'               Y_O' = Y_O + muO*res_o
//   T' = D - O' + Y_L'/muL_next   (skipped when t_out is null)
//   nl = sum res_l^2,  no = sum res_o^2
//
// T' is the solver's next factor-solve target, which the reference has XLA
// fuse into the same pass (tritd_tpu/solvers/admm.py:156-163). muL is
// annealed before T' is built, hence muL_next.
//
// Bound: bytes. 5 reads + 5 writes of the element type per element and
// ~20 flops, far below the card's ~20 flop/byte balance point. At 3.35 TB/s
// (H100 SXM data sheet) the f32 floor is about 60 us at the taxi shape
// (100x100x500) and 275 us at the video shape (240x320x300).
//
// Design: one pass, one grid-stride 1-D loop with a masked tail, so no
// padding copy. Every intermediate (r1, r2, res_l, res_o) stays in
// registers; each element is read once and each output written once. The
// TPU kernel carried its two sums in a (1,1) scratch across a sequential
// grid; Hopper blocks run in no order, so each block writes its partial
// sums (in double) to a scratch buffer and a second single-block pass adds
// them in a fixed order. The grid depends only on n, so the sums are the
// same from run to run. Vector loads, cp.async/TMA and fusing the L tile
// are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // threads per block, both passes
constexpr int kMaxBlocks = 2048;    // partial-sum slots; fixed, not per card

__device__ __forceinline__ float abs_of(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_of(double x) { return fabs(x); }
__device__ __forceinline__ float sign_as(float m, float x) { return copysignf(m, x); }
__device__ __forceinline__ double sign_as(double m, double x) { return copysign(m, x); }

template <typename T>
__device__ __forceinline__ T soft_threshold(T x, T thr) {
  // sign(x) * max(|x| - thr, 0); a NaN propagates as in jnp.maximum
  T m = abs_of(x) - thr;
  m = (m < T(0)) ? T(0) : m;
  return sign_as(m, x);
}

// Deterministic block sum: fixed shuffle tree inside each warp, then warp 0
// adds the per-warp sums in warp order. Result valid in thread 0.
__device__ __forceinline__ double block_sum(double v, double* shared) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  v = (threadIdx.x < (blockDim.x >> 5)) ? shared[threadIdx.x] : 0.0;
  if (warp == 0) {
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  __syncthreads();
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) elementwise_block_kernel(
    const T* __restrict__ d, const T* __restrict__ l, const T* __restrict__ e,
    const T* __restrict__ y_l, const T* __restrict__ y_o,
    T* __restrict__ o_out, T* __restrict__ e_out, T* __restrict__ yl_out,
    T* __restrict__ yo_out, T* __restrict__ t_out,
    double* __restrict__ partials, int64_t n,
    T mu_l, T mu_o, T lam, T mu_l_next) {
  __shared__ double shared[kThreads / 32];
  const T thr = lam / mu_o;
  const T mu_sum = mu_l + mu_o;
  double acc_l = 0.0;
  double acc_o = 0.0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const T dv = d[i];
    const T lv = l[i];
    const T ylv = y_l[i];
    const T yov = y_o[i];
    const T r1 = dv - lv + ylv / mu_l;
    const T r2 = e[i] - yov / mu_o;
    const T ov = (mu_l * r1 + mu_o * r2) / mu_sum;
    const T ev = soft_threshold(ov + yov / mu_o, thr);
    const T res_l = dv - lv - ov;
    const T res_o = ov - ev;
    const T yl_new = ylv + mu_l * res_l;
    o_out[i] = ov;
    e_out[i] = ev;
    yl_out[i] = yl_new;
    yo_out[i] = yov + mu_o * res_o;
    if (t_out != nullptr) t_out[i] = dv - ov + yl_new / mu_l_next;
    acc_l += (double)res_l * (double)res_l;
    acc_o += (double)res_o * (double)res_o;
  }
  acc_l = block_sum(acc_l, shared);
  acc_o = block_sum(acc_o, shared);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = acc_l;
    partials[gridDim.x + blockIdx.x] = acc_o;
  }
}

// Second pass, one block: thread j adds partials j, j+kThreads, ... in that
// order, then the fixed block tree.
template <typename T>
__global__ void __launch_bounds__(kThreads) finalize_kernel(
    const double* __restrict__ partials, int nblocks, T* nl_out, T* no_out) {
  __shared__ double shared[kThreads / 32];
  double acc_l = 0.0;
  double acc_o = 0.0;
  for (int j = threadIdx.x; j < nblocks; j += blockDim.x) {
    acc_l += partials[j];
    acc_o += partials[nblocks + j];
  }
  acc_l = block_sum(acc_l, shared);
  acc_o = block_sum(acc_o, shared);
  if (threadIdx.x == 0) {
    *nl_out = (T)acc_l;
    *no_out = (T)acc_o;
  }
}

template <typename T>
int launch(const T* d, const T* l, const T* e, const T* y_l, const T* y_o,
           T* o_out, T* e_out, T* yl_out, T* yo_out, T* t_out,
           T* nl_out, T* no_out, double* partials, int64_t n,
           T mu_l, T mu_o, T lam, T mu_l_next, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t want = (n + kThreads - 1) / kThreads;
  int blocks = (int)(want < kMaxBlocks ? (want > 0 ? want : 1) : kMaxBlocks);
  elementwise_block_kernel<T><<<blocks, kThreads, 0, s>>>(
      d, l, e, y_l, y_o, o_out, e_out, yl_out, yo_out, t_out, partials, n,
      mu_l, mu_o, lam, mu_l_next);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finalize_kernel<T><<<1, kThreads, 0, s>>>(partials, blocks, nl_out, no_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of doubles the caller must provide in `partials`.
int tritd_partials_len(void) { return 2 * kMaxBlocks; }

const char* tritd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns cudaGetLastError() after the launches (0 on success). Does not
// synchronize and allocates nothing.
int tritd_elementwise_block_f32(
    const float* d, const float* l, const float* e, const float* y_l, const float* y_o,
    float* o_out, float* e_out, float* yl_out, float* yo_out, float* t_out,
    float* nl_out, float* no_out, double* partials, int64_t n,
    float mu_l, float mu_o, float lam, float mu_l_next, void* stream) {
  return launch<float>(d, l, e, y_l, y_o, o_out, e_out, yl_out, yo_out, t_out,
                       nl_out, no_out, partials, n, mu_l, mu_o, lam, mu_l_next, stream);
}

int tritd_elementwise_block_f64(
    const double* d, const double* l, const double* e, const double* y_l, const double* y_o,
    double* o_out, double* e_out, double* yl_out, double* yo_out, double* t_out,
    double* nl_out, double* no_out, double* partials, int64_t n,
    double mu_l, double mu_o, double lam, double mu_l_next, void* stream) {
  return launch<double>(d, l, e, y_l, y_o, o_out, e_out, yl_out, yo_out, t_out,
                        nl_out, no_out, partials, n, mu_l, mu_o, lam, mu_l_next, stream);
}

}  // extern "C"
