// The float8_e4m3fn and float8_e5m2 instances of the flash-attention dQ
// backward (flash_bwd_dq.cuh), a library of their own: flash_bwd_dq.cu and
// flash_bwd_dq_f16.cu build the others in parallel.
#include "common.cuh"

namespace mxtt {
using Instances = TypeList<fp8e4m3, fp8e5m2>;
}  // namespace mxtt

#include "flash_bwd_dq.cuh"
