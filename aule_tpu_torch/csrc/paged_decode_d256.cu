// Paged decode for Hopper (sm_90a): the D = 256 instantiations of
// paged_decode.cuh's kernel (paged_decode.cu dispatches to them), compiled
// in a source of their own so that the head dims build in parallel.

#include "paged_decode.cuh"

namespace aule_decode {

AULE_DECODE_DIM(, 256);

}  // namespace aule_decode
