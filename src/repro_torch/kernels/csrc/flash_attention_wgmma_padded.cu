// The wgmma flash kernel's instantiations for head dims below 64 and 65-120
// (multiples of 8, zero-padded to 64 and 128; their epilogue writes the
// call's d columns), in a translation unit of their own so that nvcc builds
// them beside csrc/flash_attention_wgmma.cu, which holds the design notes,
// the dispatch and the C entry points.
#include "flash_attention_wgmma.cuh"

namespace flash_wgmma {

FLASH_WGMMA_INSTANCES(, 64, 64, 64, true)
FLASH_WGMMA_INSTANCES(, 64, 64, 128, true)
FLASH_WGMMA_INSTANCES(, 64, 128, 64, true)
FLASH_WGMMA_INSTANCES(, 64, 128, 128, true)
FLASH_WGMMA_INSTANCES(, 128, 64, 64, true)
FLASH_WGMMA_INSTANCES(, 128, 64, 128, true)
FLASH_WGMMA_INSTANCES(, 128, 128, 64, true)
FLASH_WGMMA_INSTANCES(, 128, 128, 128, true)

}  // namespace flash_wgmma
