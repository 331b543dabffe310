"""HAMLET core: the paper's contribution — shared online event trend
aggregation with dynamic sharing decisions — on PyTorch/CUDA."""
