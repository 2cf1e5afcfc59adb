"""B4 fused linear cross-entropy (forward + backward CUDA kernels)."""
