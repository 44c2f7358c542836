"""setup_s: process start (the first line of run.py) to the first timed
request: imports, first CUDA work, the codec's host tables, inputs made on
the device, the warm-up requests, and in a fresh checkout the nvcc
builds."""


def read(ctx):
    return ctx.setup_s
