// K13's staged plans at register width 64 (train_loop2_bwd.cu): their
// instantiations, compiled by their own nvcc beside train_loop2_bwd.cu's other
// staged plans and train_loop2_bwd_wide.cu, so the longest of the three sets the
// build's time, not their sum.

#define GNN_MAXF64_TU
#include "train_loop2_bwd.cu"
