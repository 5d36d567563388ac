// Entry points of the fused elementwise ADMM block (elementwise_block.cuh),
// the variants with float8_e4m3fn streams alone. Built by its own nvcc process
// beside the other elementwise_block*.cu files and linked into one library.

#include "elementwise_block.cuh"

extern "C" {

// compute float: storage e4m3 (D and T' too), masked storage e4m3 (D in C, no T'),
// einsum_dtype e4m3 alone (storage in C, T' in e4m3)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c32_de4m3_se4m3_te4m3, float, e4m3, e4m3, e4m3)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c32_d32_se4m3_te4m3, float, float, e4m3, e4m3)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c32_d32_s32_te4m3, float, float, float, e4m3)
// compute double: storage e4m3 (D and T' too), masked storage e4m3 (D in C, no T'),
// einsum_dtype e4m3 alone (storage in C, T' in e4m3)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_de4m3_se4m3_te4m3, double, e4m3, e4m3, e4m3)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_d64_se4m3_te4m3, double, double, e4m3, e4m3)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_d64_s64_te4m3, double, double, double, e4m3)

}  // extern "C"
