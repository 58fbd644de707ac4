// K11's wide plan (eval_loop2_bwd.cu, tile2.cuh kTile2Wide): its one
// instantiation, compiled by its own nvcc beside eval_loop2_bwd.cu's staged
// plans, so the longer of the two sets the build's time, not their sum.

#define GNN_WIDE_TU
#include "eval_loop2_bwd.cu"
