// Entry points of the fused elementwise ADMM block (elementwise_block.cuh),
// compute double with storage and einsum in two different narrow types. Built
// by its own nvcc process beside the other elementwise_block*.cu files and
// linked into one library.

#include "elementwise_block.cuh"

extern "C" {

// compute double: D, E, Y_L, Y_O and the outputs in the storage type S, T' in the
// einsum type T, S and T two different narrow types
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_dbf16_sbf16_tf16, double, bf16, bf16, f16)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_dbf16_sbf16_te4m3, double, bf16, bf16, e4m3)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_dbf16_sbf16_te5m2, double, bf16, bf16, e5m2)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_df16_sf16_tbf16, double, f16, f16, bf16)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_df16_sf16_te4m3, double, f16, f16, e4m3)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_df16_sf16_te5m2, double, f16, f16, e5m2)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_de4m3_se4m3_tbf16, double, e4m3, e4m3, bf16)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_de4m3_se4m3_tf16, double, e4m3, e4m3, f16)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_de4m3_se4m3_te5m2, double, e4m3, e4m3, e5m2)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_de5m2_se5m2_tbf16, double, e5m2, e5m2, bf16)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_de5m2_se5m2_tf16, double, e5m2, e5m2, f16)
TRITD_BLOCK_ENTRY(tritd_elementwise_block_c64_de5m2_se5m2_te4m3, double, e5m2, e5m2, e4m3)

}  // extern "C"
