// The wgmma flash kernel's instantiations at padded head dim 256 (K/V
// sub-tiles of 64 keys; d == 256 and d 136-248), in a translation unit of
// their own so that nvcc builds them beside csrc/flash_attention_wgmma.cu,
// which holds the design notes, the dispatch and the C entry points.
#include "flash_attention_wgmma.cuh"

namespace flash_wgmma {

FLASH_WGMMA_INSTANCES(, 256, 64, 64, false)
FLASH_WGMMA_INSTANCES(, 256, 128, 64, false)
FLASH_WGMMA_INSTANCES(, 256, 64, 64, true)
FLASH_WGMMA_INSTANCES(, 256, 128, 64, true)

}  // namespace flash_wgmma
