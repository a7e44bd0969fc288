// The float8_e4m3fn and float8_e5m2 instances of the flash-attention forward
// (flash_fwd.cuh), a library of their own: flash_fwd.cu and flash_fwd_f16.cu
// build the others in parallel.
#include "common.cuh"

namespace mxtt {
using Instances = TypeList<fp8e4m3, fp8e5m2>;
}  // namespace mxtt

#include "flash_fwd.cuh"
