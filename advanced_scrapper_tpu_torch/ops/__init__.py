"""Device operations: plain PyTorch versions and the CUDA kernel's wrapper."""
