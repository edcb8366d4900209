"""`torch.cuda.max_memory_allocated()` over set-up and window, in GiB;
None off the card."""


def read(run):
    b = run.get("peak_bytes")
    return None if b is None else b / 2 ** 30
