"""Hand-written CUDA kernels for Hopper (sm_90a), built from `csrc/` by
`build`, each with its plain PyTorch version beside it."""
