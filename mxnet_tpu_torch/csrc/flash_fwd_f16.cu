// The float16 instances of the flash-attention forward (flash_fwd.cuh), a
// library of their own: flash_fwd.cu and flash_fwd_f8.cu build the others in
// parallel.
#include "common.cuh"

namespace mxtt {
using Instances = TypeList<__half>;
}  // namespace mxtt

#include "flash_fwd.cuh"
