// The float16 instances of the flash-attention dK/dV backward (flash_bwd.cuh),
// a library of their own: flash_bwd.cu and flash_bwd_f8.cu build the others in
// parallel.
#include "common.cuh"

namespace mxtt {
using Instances = TypeList<__half>;
}  // namespace mxtt

#include "flash_bwd.cuh"
