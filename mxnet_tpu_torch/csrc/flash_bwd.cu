// The float32 and bfloat16 instances of the flash-attention dK/dV backward
// (flash_bwd.cuh), a library of their own: flash_bwd_f16.cu and flash_bwd_f8.cu
// build the others in parallel.
#include "common.cuh"

namespace mxtt {
using Instances = TypeList<float, __nv_bfloat16>;
}  // namespace mxtt

#include "flash_bwd.cuh"
