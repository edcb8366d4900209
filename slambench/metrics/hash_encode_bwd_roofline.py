"""`hash_encode_bwd`'s share (%) of its roofline over the profiled stretch (the
kernel's file under kernels/ counts its bytes and operations)."""

from slambench.lib import roofline


def read(run):
    return roofline(run, "hash_encode_bwd")
