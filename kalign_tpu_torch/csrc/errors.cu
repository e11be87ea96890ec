/* Error text for the codes the kalign_tpu_torch C entry points return. */
#include "kt_cuda.h"

KT_EXPORT const char* kt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
