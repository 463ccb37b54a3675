"""Plain PyTorch ops and the CUDA kernel builder."""
