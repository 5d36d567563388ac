// Entry points of the fused elementwise ADMM block (elementwise_block.cuh),
// compute double beside the other wide type, float: the data-sized streams or T'
// in float, and T' in double beside other storage (einsum_dtype equal to the
// compute dtype). Built by its own nvcc process beside the other
// elementwise_block*.cu files and linked into one library.

#include "elementwise_block.cuh"

extern "C" {

// compute double: storage float (D and T' too), masked storage float (D in C, no T'),
// einsum_dtype float alone (storage in C, T' in float)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_d32_s32_t32, double, float, float, float)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_d64_s32_t32, double, double, float, float)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_d64_s64_t32, double, double, double, float)
// storage float with a narrow einsum dtype or double (T' in it)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_d32_s32_tbf16, double, float, float, bf16)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_d32_s32_tf16, double, float, float, f16)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_d32_s32_te4m3, double, float, float, e4m3)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_d32_s32_te5m2, double, float, float, e5m2)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_d32_s32_t64, double, float, float, double)
// narrow storage with einsum_dtype float or double (T' in it)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_dbf16_sbf16_t32, double, bf16, bf16, float)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_dbf16_sbf16_t64, double, bf16, bf16, double)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_df16_sf16_t32, double, f16, f16, float)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_df16_sf16_t64, double, f16, f16, double)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_de4m3_se4m3_t32, double, e4m3, e4m3, float)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_de4m3_se4m3_t64, double, e4m3, e4m3, double)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_de5m2_se5m2_t32, double, e5m2, e5m2, float)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_de5m2_se5m2_t64, double, e5m2, e5m2, double)

}  // extern "C"
