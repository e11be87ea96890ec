/* Shared definitions of the kalign_tpu_torch CUDA kernels.
 *
 * Every kernel is launched through a plain C entry point that takes
 * raw device pointers and the caller's stream, launches once, and
 * returns cudaGetLastError() so that a refused launch (too many
 * threads, too much shared memory) reaches the Python wrapper, which
 * raises.  Nothing here allocates or synchronises.
 *
 * Float contract: the library is compiled with -fmad=false, so no
 * multiply feeding an add is contracted into an FMA; each kernel
 * repeats its plain PyTorch version's operations one by one.
 */
#ifndef KT_CUDA_H
#define KT_CUDA_H

#include <cuda_runtime.h>
#include <stdint.h>

#define KT_NEG (-3.0e38f)

/* decision encodings (shared with the traceback walk)
 *   A-cell (bits 0-1): 0 = diagonal from A, 1 = from GA, 2 = from GB
 *   GA-cell (bit 2):   set = extend (from GA), clear = open (from A)
 *   GB-cell (bit 3):   set = extend (from GB), clear = open (from A) */
#define KT_DEC_A_MASK 3
#define KT_DEC_GA_EXT 4
#define KT_DEC_GB_EXT 8

#define KT_EXPORT extern "C" __attribute__((visibility("default")))

#endif
