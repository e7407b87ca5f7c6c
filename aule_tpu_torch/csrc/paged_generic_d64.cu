// Paged decode for f32 q (sm_90a): the D = 64 instantiations of
// paged_generic.cuh's kernel (paged_generic.cu dispatches to them),
// compiled in a source of their own so that the head dims build in
// parallel.

#include "paged_generic.cuh"

namespace aule_generic {

AULE_GENERIC_DECODE_DIM(, 64);

}  // namespace aule_generic
