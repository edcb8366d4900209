"""Seconds from the harness's start to the window's: imports, the kernel
load (and build, on a checkout's first run), the frame pool, the program's
construction and the warm-up frames."""


def read(run):
    return run["setup_s"]
