"""matplotlib where it is installed, and figures skipped where it is not.

The JAX package draws its figures (ATE plots, diagnostic panels, colour
maps) with matplotlib. The port's machine need not have it: a figure is
then not written, and the run says so once with an `INFO:` line. Every
number the figures show is still computed and written.
"""

from __future__ import annotations

_said = False


def pyplot():
    """`matplotlib.pyplot` on the Agg backend, or None when matplotlib is
    not installed (said once per process)."""
    global _said
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        if not _said:
            print("INFO: matplotlib is not installed: figure files are not "
                  "written (every number still is)")
            _said = True
        return None
    return plt
