"""collective_ms.sfdp: device ms a frame of the NCCL kernels in rank 0's
profiled stretch (the only rank profiled): ``mesh.gather``'s two
all-gathers (the shard sizes, then the rows) and ``mesh.all_ok``'s
all-reduce.  The harness's own go/stop broadcast, NCCL's only broadcast
kernel here, is left out.  A kernel's time holds its wait for the other
ranks as well as the transfer; the copies around it (the gather's
concatenation, the sizes read back) are not in it."""


def read(ctx):
    s = ctx.summary
    if s is None:
        return None
    sec = sum(v for k, v in s.kernel_s.items()
              if "nccl" in k.lower() and "broadcast" not in k.lower())
    if sec <= 0:
        return None
    p = ctx.workload["params"]
    frames = p["trace"]["requests"] * p.get("frames_per_request", 1)
    return 1e3 * sec / frames
