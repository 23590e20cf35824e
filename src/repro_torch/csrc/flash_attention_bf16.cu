// K6's bf16 half: flash_attention.cu with VPAAS_FLASH_BF16 defined (the
// wgmma + TMA kernels, the d <= 64 kernels, the CUDA-core kernel's bf16
// instances, vpaas_flash_attention_bf16 and the block-rows and kernel
// queries),
// a source of its own so that nvcc builds it beside the float32 half.
#define VPAAS_FLASH_BF16
#include "flash_attention.cu"
