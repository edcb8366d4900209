"""CUDA launch calls (`cudaLaunchKernel`, `cudaLaunchKernelExC`,
`cuLaunchKernel`) in the profiled stretch over its frames."""


def read(run):
    tr = run.get("trace")
    return tr["launches"] / tr["frames"] if tr else None
