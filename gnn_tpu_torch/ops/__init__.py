"""MLP, aggregation and the eval propagation kernels."""
