// Entry points of the fused elementwise ADMM block (elementwise_block.cuh):
// the kernel's geometry, the error string, and the variants in float,
// double and bf16. The float16 and float8 variants are in the other
// elementwise_block*.cu files, each built by its own nvcc process; all are
// linked into one library.

#include "elementwise_block.cuh"

extern "C" {

int tritd_max_blocks(void) { return kMaxBlocks; }
int tritd_block_threads(void) { return kThreads; }
int tritd_scratch_len(void) { return 2 * kMaxBlocks + 1; }

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
