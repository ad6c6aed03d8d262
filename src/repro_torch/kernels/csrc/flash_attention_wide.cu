// The mma flash kernel's instantiations at padded head dims 160, 192 and
// 256 (q read from shared memory at each product), in a translation unit of
// their own so that nvcc builds them beside csrc/flash_attention.cu, which
// holds the design notes, the dispatch and the C entry points.
#include "flash_attention_mma.cuh"

namespace flash_mma {

FLASH_MMA_INSTANCES(, float, 160)
FLASH_MMA_INSTANCES(, __nv_bfloat16, 160)
FLASH_MMA_INSTANCES(, float, 192)
FLASH_MMA_INSTANCES(, __nv_bfloat16, 192)
FLASH_MMA_INSTANCES(, float, 256)
FLASH_MMA_INSTANCES(, __nv_bfloat16, 256)

}  // namespace flash_mma
