// K16's and K17's wide plans (bn_typed.cu): their instantiations, compiled by
// their own nvcc beside bn_typed.cu's staged plans, so the longer of the two
// sets the build's time, not their sum.

#define GNN_WIDE_TU
#include "bn_typed.cu"
