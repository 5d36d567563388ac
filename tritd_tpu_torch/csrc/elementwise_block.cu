// Fused elementwise ADMM block for NVIDIA Hopper (sm_90a).
//
// Replaces: tritd_tpu/ops/pallas_kernels.py::_kernel (launched by
// _block_pallas through pl.pallas_call), and the XLA fusion
// _block_jnp(compute_dtype=..., store_dtype=...) that the reference uses for
// narrow storage, which its Pallas body refuses. Per element, with scalars
// muL, muO, lam and muL_next, all arithmetic in the compute type C:
//
//   r1 = D - L + Y_L/muL          O'   = (muL*r1 + muO*r2) / (muL + muO)
//   r2 = E - Y_O/muO              E'   = soft(O' + Y_O/muO, lam/muO)
//   res_l = D - L - O'            Y_L' = Y_L + muL*res_l
//   res_o = O' - E'               Y_O' = Y_O + muO*res_o
//   T' = D - S(O') + S(Y_L')/muL_next   (skipped when t_out is null)
//   nl = sum res_l^2,  no = sum res_o^2
//
// T' is the solver's next factor-solve target, which the reference has XLA
// fuse into the same pass (tritd_tpu/solvers/admm.py:156-163). muL is
// annealed before T' is built, hence muL_next. S(.) is the value as stored:
// in narrow storage the reference builds T' from O' and Y_L' after they were
// rounded to the storage type (admm.py:159-163 reads them after the
// astype(store_dtype) of pallas_kernels.py:62-65), so the kernel rounds,
// widens again, and only then forms T'. With storage in C the round trip is
// the identity.
//
// Types: C (compute, L, the scalars and the sums) is float or double. D is
// the data's stored type: the storage type when the solver stores it
// narrow, C in masked mode (the imputation promotes it). S (E, Y_L, Y_O and
// the four outputs) is C or bf16. T (T') is S, or bf16 with storage in C
// (the solver's einsum_dtype). The entry points at the end instantiate the
// combinations the solver produces.
//
// Bound: bytes. 5 reads + 5 writes per element and ~20 flops, far below the
// card's ~20 flop/byte balance point. At f32: 40 B per element with T', so
// about 60 us at the taxi shape (100x100x500) and 275 us at the video shape
// (240x320x300) at 3.35 TB/s (H100 SXM data sheet). Narrow storage with T'
// moves 22 B per element (D 2 + L 4 + 3 x 2 read, 5 x 2 written), and so
// does masked narrow storage (D 4 + L 4 + 3 x 2 read, 4 x 2 written).
//
// Design: one pass, one grid-stride 1-D loop with a masked tail, so no
// padding copy. Every intermediate stays in registers; each element is read
// once and each output written once, with the type conversions folded into
// the loads and stores. The TPU kernel carried its two sums in a (1,1)
// scratch across a sequential grid; Hopper blocks run in no order, so each
// block writes its partial sums (in double) to a scratch buffer and a second
// single-block pass adds them in a fixed order. The grid depends only on n,
// so the sums are the same from run to run. Vector loads, cp.async/TMA and
// fusing the L tile are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;       // threads per block, both passes
constexpr int kMaxBlocks = 2048;    // partial-sum slots; fixed, not per card

__device__ __forceinline__ float abs_of(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_of(double x) { return fabs(x); }
__device__ __forceinline__ float sign_as(float m, float x) { return copysignf(m, x); }
__device__ __forceinline__ double sign_as(double m, double x) { return copysign(m, x); }

// Conversions between the storage types and the compute type. bf16 is
// rounded to nearest even; a double goes to bf16 through float, as
// PyTorch's own conversion does.
template <typename To, typename From>
struct Cvt {
  static __device__ __forceinline__ To run(From x) { return static_cast<To>(x); }
};
template <>
struct Cvt<float, bf16> {
  static __device__ __forceinline__ float run(bf16 x) { return __bfloat162float(x); }
};
template <>
struct Cvt<double, bf16> {
  static __device__ __forceinline__ double run(bf16 x) { return (double)__bfloat162float(x); }
};
template <>
struct Cvt<bf16, float> {
  static __device__ __forceinline__ bf16 run(float x) { return __float2bfloat16_rn(x); }
};
template <>
struct Cvt<bf16, double> {
  static __device__ __forceinline__ bf16 run(double x) { return __float2bfloat16_rn((float)x); }
};
template <>
struct Cvt<bf16, bf16> {
  static __device__ __forceinline__ bf16 run(bf16 x) { return x; }
};

template <typename To, typename From>
__device__ __forceinline__ To cvt(From x) { return Cvt<To, From>::run(x); }

template <typename C>
__device__ __forceinline__ C soft_threshold(C x, C thr) {
  // sign(x) * max(|x| - thr, 0); a NaN propagates as in jnp.maximum
  C m = abs_of(x) - thr;
  m = (m < C(0)) ? C(0) : m;
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

template <typename C, typename D, typename S, typename T>
__global__ void __launch_bounds__(kThreads) elementwise_block_kernel(
    const D* __restrict__ d, const C* __restrict__ l, const S* __restrict__ e,
    const S* __restrict__ y_l, const S* __restrict__ y_o,
    S* __restrict__ o_out, S* __restrict__ e_out, S* __restrict__ yl_out,
    S* __restrict__ yo_out, T* __restrict__ t_out,
    double* __restrict__ partials, int64_t n,
    C mu_l, C mu_o, C lam, C mu_l_next) {
  __shared__ double shared[kThreads / 32];
  const C thr = lam / mu_o;
  const C mu_sum = mu_l + mu_o;
  double acc_l = 0.0;
  double acc_o = 0.0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const C dv = cvt<C>(d[i]);
    const C lv = l[i];
    const C ylv = cvt<C>(y_l[i]);
    const C yov = cvt<C>(y_o[i]);
    const C r1 = dv - lv + ylv / mu_l;
    const C r2 = cvt<C>(e[i]) - yov / mu_o;
    const C ov = (mu_l * r1 + mu_o * r2) / mu_sum;
    const C ev = soft_threshold(ov + yov / mu_o, thr);
    const C res_l = dv - lv - ov;
    const C res_o = ov - ev;
    const S o_st = cvt<S>(ov);
    const S yl_st = cvt<S>(ylv + mu_l * res_l);
    o_out[i] = o_st;
    e_out[i] = cvt<S>(ev);
    yl_out[i] = yl_st;
    yo_out[i] = cvt<S>(yov + mu_o * res_o);
    if (t_out != nullptr) {
      t_out[i] = cvt<T>(dv - cvt<C>(o_st) + cvt<C>(yl_st) / mu_l_next);
    }
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
template <typename C>
__global__ void __launch_bounds__(kThreads) finalize_kernel(
    const double* __restrict__ partials, int nblocks, C* nl_out, C* no_out) {
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
    *nl_out = (C)acc_l;
    *no_out = (C)acc_o;
  }
}

template <typename C, typename D, typename S, typename T>
int launch(const D* d, const C* l, const S* e, const S* y_l, const S* y_o,
           S* o_out, S* e_out, S* yl_out, S* yo_out, T* t_out,
           C* nl_out, C* no_out, double* partials, int64_t n,
           C mu_l, C mu_o, C lam, C mu_l_next, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t want = (n + kThreads - 1) / kThreads;
  int blocks = (int)(want < kMaxBlocks ? (want > 0 ? want : 1) : kMaxBlocks);
  elementwise_block_kernel<C, D, S, T><<<blocks, kThreads, 0, s>>>(
      d, l, e, y_l, y_o, o_out, e_out, yl_out, yo_out, t_out, partials, n,
      mu_l, mu_o, lam, mu_l_next);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finalize_kernel<C><<<1, kThreads, 0, s>>>(partials, blocks, nl_out, no_out);
  return (int)cudaGetLastError();
}

}  // namespace

// One C entry point per (C, D, S, T) combination. Each returns
// cudaGetLastError() after the launches (0 on success), does not
// synchronize and allocates nothing.
#define TRITD_BLOCK_ENTRY(NAME, C, D, S, T)                                      \
  int NAME(const D* d, const C* l, const S* e, const S* y_l, const S* y_o,      \
           S* o_out, S* e_out, S* yl_out, S* yo_out, T* t_out, C* nl_out,       \
           C* no_out, double* partials, int64_t n, C mu_l, C mu_o, C lam,       \
           C mu_l_next, void* stream) {                                         \
    return launch<C, D, S, T>(d, l, e, y_l, y_o, o_out, e_out, yl_out, yo_out,  \
                              t_out, nl_out, no_out, partials, n, mu_l, mu_o,   \
                              lam, mu_l_next, stream);                          \
  }

extern "C" {

// Number of doubles the caller must provide in `partials`.
int tritd_partials_len(void) { return 2 * kMaxBlocks; }

const char* tritd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Everything in one type.
TRITD_BLOCK_ENTRY(tritd_elementwise_block_f32, float, float, float, float)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_f64, double, double, double, double)
// Narrow storage: D, E, Y_L, Y_O, the outputs and T' in bf16.
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c32_dbf16_sbf16_tbf16, float, bf16, bf16, bf16)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_dbf16_sbf16_tbf16, double, bf16, bf16, bf16)
// Masked narrow storage: the imputed D in C, the rest narrow, no T'.
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c32_d32_sbf16_tbf16, float, float, bf16, bf16)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_d64_sbf16_tbf16, double, double, bf16, bf16)
// einsum_dtype alone: storage in C, T' in bf16.
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c32_d32_s32_tbf16, float, float, float, bf16)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_d64_s64_tbf16, double, double, double, bf16)

}  // extern "C"
