// K11's staged plans at register width 64 (eval_loop2_bwd.cu): their
// instantiations, compiled by their own nvcc beside eval_loop2_bwd.cu's other
// staged plans and eval_loop2_bwd_wide.cu, so the longest of the three sets the
// build's time, not their sum.

#define GNN_MAXF64_TU
#include "eval_loop2_bwd.cu"
