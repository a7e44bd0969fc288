// The float32 and bfloat16 instances of the flash-attention forward
// (flash_fwd.cuh), a library of their own: flash_fwd_f16.cu and flash_fwd_f8.cu
// build the others in parallel.
#include "common.cuh"

namespace mxtt {
using Instances = TypeList<float, __nv_bfloat16>;
}  // namespace mxtt

#include "flash_fwd.cuh"
