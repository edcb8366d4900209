"""The whole step's share (%) of the card's f32 peak over the profiled
stretch: the operations its iterations need, counted from shapes (hash
interpolation forward and backward, the table-gradient sums, compositing,
the decoders' products, Adam), over the stretch's wall time at 67
TFLOP/s. The loop computes in f32 and the port keeps TF32 off, so the
f32 rate outside the tensor cores is the peak."""

from slambench.lib import F32_FLOPS, kernel_work

WORK = ("hash_encode_fwd", "hash_encode_bwd", "scatter_accum", "composite",
        "decoders", "adam")


def read(run):
    tr = run.get("trace")
    if not tr:
        return None
    flops = sum(kernel_work(k, run["shapes"], tr["iters"])[2] for k in WORK)
    return 100.0 * flops / (tr["wall_s"] * F32_FLOPS)
