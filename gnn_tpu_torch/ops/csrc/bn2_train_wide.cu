// K15's wide plan (bn2_train.cu, tile2.cuh kTile2Wide): its one
// instantiation, compiled by its own nvcc beside bn2_train.cu's staged plans,
// so the longer of the two sets the build's time, not their sum.

#define GNN_WIDE_TU
#include "bn2_train.cu"
