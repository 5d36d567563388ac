// Entry points of the fused elementwise ADMM block (elementwise_block.cuh),
// the variants with float16 (IEEE half) streams alone. Built by its own nvcc
// process beside the other elementwise_block*.cu files and linked into one
// library.

#include "elementwise_block.cuh"

extern "C" {

// compute float: storage f16 (D and T' too), masked storage f16 (D in C, no T'),
// einsum_dtype f16 alone (storage in C, T' in f16)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c32_df16_sf16_tf16, float, f16, f16, f16)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c32_d32_sf16_tf16, float, float, f16, f16)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c32_d32_s32_tf16, float, float, float, f16)
// compute double: storage f16 (D and T' too), masked storage f16 (D in C, no T'),
// einsum_dtype f16 alone (storage in C, T' in f16)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_df16_sf16_tf16, double, f16, f16, f16)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_d64_sf16_tf16, double, double, f16, f16)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_d64_s64_tf16, double, double, double, f16)

}  // extern "C"
