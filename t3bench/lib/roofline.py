"""A kernel's share of its roofline, from its roofline file.

The least time the card could take is the bytes the calls need (each
tensor argument of the kernel's Python entry point read once, each tensor
it returns written once, counted by ``trace.Tracer`` over the profiled
stretch) over the peak memory rate of ``peaks.json``; the share is that
over the device time of the kernels whose name holds the file's
``name_pattern`` in the same stretch.  Both kernels here do a few
integer operations a byte, so the memory bound is the larger one.
"""


def share(ctx, kernel: str):
    rf = ctx.rooflines.get(kernel)
    if rf is None or ctx.summary is None:
        return None
    dev_s = ctx.summary.kernel_seconds(rf["name_pattern"])
    nbytes = ctx.kernel_bytes.get(kernel, 0)
    if dev_s <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / ctx.peaks[rf["peak"]] / dev_s
