// K16's and K17's staged plans at register width 64 (bn_typed.cu): their
// instantiations, compiled by their own nvcc beside bn_typed.cu's other
// staged plans and bn_typed_wide.cu, so the longest of the three sets the
// build's time, not their sum.

#define GNN_MAXF64_TU
#include "bn_typed.cu"
