"""train.peak_gib: the device memory the allocator held at most over the
window (``max_memory_allocated``), in GiB."""


def read(ctx):
    return ctx["peak_bytes"] / 2**30 if ctx.get("peak_bytes") else None
