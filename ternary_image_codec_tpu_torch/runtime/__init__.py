"""Runtime of the PyTorch port: the CUDA kernels' build (build.py), the
native host library (native.py), the pipelined executor (executor.py) and
tracing (tracing.py)."""
