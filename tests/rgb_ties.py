"""The boundary pixels that catch a BT.601 row computed with fewer
roundings: every triple of 0, 1, 127, 128, 254, 255, and the triples at
the rows' tie points, where contracting the last product and sum of a row
into one rounding (an FMA) moves the lround.  Plain torch, no JAX: the
RGB codec tests and the bridge kernels' tests share it."""
import torch

from t3bench.reference import pixels


def boundary_pixels() -> torch.Tensor:
    """(n, 3) uint8: the grid of boundary values, then every triple whose
    row value held exactly beside that single rounding (float64 before the
    one cast to float32) rounds otherwise."""
    vals = torch.tensor([0, 1, 127, 128, 254, 255])
    grid = torch.stack(torch.meshgrid(vals, vals, vals, indexing="ij"),
                       -1).reshape(-1, 3)
    v = torch.arange(1 << 24, dtype=torch.int32)
    rgb = torch.stack([v >> 16, (v >> 8) & 255, v & 255], -1)
    x = rgb.to(torch.float32)
    ties = torch.zeros(len(v), dtype=torch.bool)
    for row, add in ((pixels.Y_ROW, 0.0), (pixels.CB_ROW, 128.0),
                     (pixels.CR_ROW, 128.0)):
        c = [torch.tensor(k, dtype=torch.float32) for k in row]
        head = c[0] * x[:, 0] + c[1] * x[:, 1]
        sep = head + c[2] * x[:, 2]
        fma = (head.double() + c[2].double() * x[:, 2].double()).float()
        ties |= torch.floor(sep + add + 0.5) != torch.floor(fma + add + 0.5)
    out = torch.cat([grid, rgb[ties]]).to(torch.uint8)
    assert len(out) > len(grid) + 100
    return out
