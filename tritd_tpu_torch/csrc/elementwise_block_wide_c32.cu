// Entry points of the fused elementwise ADMM block (elementwise_block.cuh),
// compute float beside the other wide type, double: the data-sized streams or T'
// in double, and T' in float beside other storage (einsum_dtype equal to the
// compute dtype). Built by its own nvcc process beside the other
// elementwise_block*.cu files and linked into one library.

#include "elementwise_block.cuh"

extern "C" {

// compute float: storage double (D and T' too), masked storage double (D in C, no T'),
// einsum_dtype double alone (storage in C, T' in double)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c32_d64_s64_t64, float, double, double, double)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c32_d32_s64_t64, float, float, double, double)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c32_d32_s32_t64, float, float, float, double)
// storage double with a narrow einsum dtype or float (T' in it)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c32_d64_s64_tbf16, float, double, double, bf16)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c32_d64_s64_tf16, float, double, double, f16)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c32_d64_s64_te4m3, float, double, double, e4m3)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c32_d64_s64_te5m2, float, double, double, e5m2)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c32_d64_s64_t32, float, double, double, float)
// narrow storage with einsum_dtype double or float (T' in it)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c32_dbf16_sbf16_t64, float, bf16, bf16, double)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c32_dbf16_sbf16_t32, float, bf16, bf16, float)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c32_df16_sf16_t64, float, f16, f16, double)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c32_df16_sf16_t32, float, f16, f16, float)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c32_de4m3_se4m3_t64, float, e4m3, e4m3, double)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c32_de4m3_se4m3_t32, float, e4m3, e4m3, float)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c32_de5m2_se5m2_t64, float, e5m2, e5m2, double)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c32_de5m2_se5m2_t32, float, e5m2, e5m2, float)

}  // extern "C"
