// Entry points of the fused elementwise ADMM block (elementwise_block.cuh):
// the kernel's geometry, the error string, the check of its division, and
// the variants in float, double and bf16. The float16 and float8 variants
// are in the other elementwise_block*.cu files, each built by its own nvcc
// process; all are linked into one library.

#include "elementwise_block.cuh"

namespace {

// The check of Quotient against '/' (div.rn), kept here so that it runs the
// same inline code as the block; nothing on the solve path calls it (its
// callers are tools/sweep_block.quotient_check, chip_smoke.py phase 2 and a
// card test). For the divisor ys[blockIdx.y] and the numerators
// x_bits(first + i), i < count, adds to counts[2 k] the x whose quotient as
// the block kernel takes it (Quotient where it says ok, else '/') differs
// from '/' in any bit, and to counts[2 k + 1] those that took Quotient's
// path. float: the numerators are the bit patterns first, first + 1, ...;
// double: splitmix64 of the index, every other one with its exponent drawn
// into [2^-70, 2^70).
__device__ __forceinline__ float x_bits(float, uint64_t i) { return __uint_as_float((unsigned)i); }
__device__ __forceinline__ double x_bits(double, uint64_t i) {
  uint64_t z = i + 0x9e3779b97f4a7c15ull;
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  z ^= z >> 31;
  if (i & 1) z = (z & 0x800fffffffffffffull) | ((uint64_t)(1023 - 70 + (z >> 52) % 140) << 52);
  return __longlong_as_double((long long)z);
}
__device__ __forceinline__ bool same_bits(float a, float b) { return __float_as_uint(a) == __float_as_uint(b); }
__device__ __forceinline__ bool same_bits(double a, double b) {
  return __double_as_longlong(a) == __double_as_longlong(b);
}

template <typename C>
__global__ void __launch_bounds__(kThreads) quotient_check_kernel(const C* __restrict__ ys, uint64_t first,
                                                                  uint64_t count, unsigned long long* counts) {
  const C y = ys[blockIdx.y];
  const Quotient<C> q(y);
  const bool fast = divisor_in_range(y);
  unsigned long long bad = 0, taken = 0;
  for (uint64_t i = (uint64_t)blockIdx.x * kThreads + threadIdx.x; i < count; i += (uint64_t)gridDim.x * kThreads) {
    const C x = x_bits(C(0), first + i);
    bool ok = fast;
    C got = q(x, ok);
    taken += ok;
    if (!ok) got = x / y;
    bad += !same_bits(got, x / y);
  }
  if (bad) atomicAdd(counts + 2 * blockIdx.y, bad);
  if (taken) atomicAdd(counts + 2 * blockIdx.y + 1, taken);
}

template <typename C>
int quotient_check(const C* ys, int ny, uint64_t first, uint64_t count, unsigned long long* counts, void* stream) {
  if (ny < 1 || ny > 65535) return (int)cudaErrorInvalidValue;
  quotient_check_kernel<C><<<dim3(4 * kMaxBlocks, ny), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ys, first, count, counts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tritd_max_blocks(void) { return kMaxBlocks; }
int tritd_block_threads(void) { return kThreads; }
int tritd_scratch_len(void) { return kScratchLen; }

const char* tritd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The bitwise check of the kernel's division against '/' (quotient_check
// in elementwise_block.cuh); `counts` holds 2 * ny zeroed counters.
int tritd_quotient_check_f32(const float* ys, int ny, uint64_t first, uint64_t count, unsigned long long* counts,
                             void* stream) {
  return quotient_check<float>(ys, ny, first, count, counts, stream);
}
int tritd_quotient_check_f64(const double* ys, int ny, uint64_t first, uint64_t count, unsigned long long* counts,
                             void* stream) {
  return quotient_check<double>(ys, ny, first, count, counts, stream);
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
