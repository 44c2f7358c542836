"""Rank side of tests/test_torch_mesh.py.

Rank processes import this module afresh, so it imports torch, numpy and
the port, never jax: the test module itself must stay out of them.
"""
from ternary_image_codec_tpu_torch.parallel import mesh as M


def run_legs(rank, world, legs):
    """Run each leg ``(name, function, args, kwargs)`` of parallel/mesh.py
    on a ``world``-rank mesh (the PP function on ``make_mesh_pp``); for
    each, this rank's local output shapes and the gathered outputs as
    numpy (a 0-d output is global already), or the ValueError's message."""
    mesh = M.make_mesh(world)
    pp = M.make_mesh_pp(world)
    out = {}
    for name, fn, args, kwargs in legs:
        m = pp if fn == "roundtrip_pipeline_pp" else mesh
        try:
            res = getattr(M, fn)(*args, mesh=m, **kwargs)
        except ValueError as e:
            out[name] = {"error": str(e)}
            continue
        res = res if isinstance(res, tuple) else (res,)
        kw = ({"dim": 1, "axis": "data"} if fn == "roundtrip_pipeline_pp"
              else {})
        out[name] = {
            "local": [tuple(x.shape) for x in res],
            "global": [(x if x.dim() == 0 else M.gather(m, x, **kw))
                       .cpu().numpy() for x in res]}
    return out


def fail_on(rank, world, bad):
    if rank == bad:
        raise ValueError(f"rank {rank} says no")
    return rank


def sleep(rank, world, seconds):
    import time
    time.sleep(seconds)
