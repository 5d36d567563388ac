// Entry points of the fused elementwise ADMM block (elementwise_block.cuh),
// the variants with float8_e5m2 streams alone. Built by its own nvcc process
// beside the other elementwise_block*.cu files and linked into one library.

#include "elementwise_block.cuh"

extern "C" {

// compute float: storage e5m2 (D and T' too), masked storage e5m2 (D in C, no T'),
// einsum_dtype e5m2 alone (storage in C, T' in e5m2)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c32_de5m2_se5m2_te5m2, float, e5m2, e5m2, e5m2)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c32_d32_se5m2_te5m2, float, float, e5m2, e5m2)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c32_d32_s32_te5m2, float, float, float, e5m2)
// compute double: storage e5m2 (D and T' too), masked storage e5m2 (D in C, no T'),
// einsum_dtype e5m2 alone (storage in C, T' in e5m2)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_de5m2_se5m2_te5m2, double, e5m2, e5m2, e5m2)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_d64_se5m2_te5m2, double, double, e5m2, e5m2)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_d64_s64_te5m2, double, double, double, e5m2)

}  // extern "C"
