"""peak_gib: ``torch.cuda.max_memory_allocated()`` over the window, its
counter reset at the window's start, so resident inputs count."""


def read(ctx):
    return None if ctx.peak_bytes is None else ctx.peak_bytes / 2 ** 30
