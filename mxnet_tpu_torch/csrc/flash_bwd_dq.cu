// The float32 and bfloat16 instances of the flash-attention dQ backward
// (flash_bwd_dq.cuh), a library of their own: flash_bwd_dq_f16.cu and
// flash_bwd_dq_f8.cu build the others in parallel.
#include "common.cuh"

namespace mxtt {
using Instances = TypeList<float, __nv_bfloat16>;
}  // namespace mxtt

#include "flash_bwd_dq.cuh"
