"""Hand-written CUDA kernels: build/load helpers and launch counters."""
