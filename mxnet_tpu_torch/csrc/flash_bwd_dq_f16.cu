// The float16 instances of the flash-attention dQ backward (flash_bwd_dq.cuh),
// a library of their own: flash_bwd_dq.cu and flash_bwd_dq_f8.cu build the
// others in parallel.
#include "common.cuh"

namespace mxtt {
using Instances = TypeList<__half>;
}  // namespace mxtt

#include "flash_bwd_dq.cuh"
