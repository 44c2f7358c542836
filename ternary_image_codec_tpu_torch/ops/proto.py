"""Transform prototypes (lossy "no-entropy" source coding) in torch.

The JAX package's ops/proto.py.  Three prototypes of the C++ reference:

* T1 Haar ternary tiles: a single-level integer-lifting 2D Haar per NxN
  tile of Y; LL kept as u8, the detail coefficients ternarized by
  +-thresh (include/proto_noentropy.hpp:94-218, :334-366).
* T2 spectral sketch: NN downscale, a block-mean grid, the 2D DCT-II,
  radial x angle bins of |F|, a median/MAD z-score ternarized
  (include/proto_noentropy.hpp:220-329).
* T3 AnisoRC: a discrete Radon projection of each 32x32 block on 8 fixed
  angles, a 1D Haar of each projection, median/MAD ternarized details;
  the reconstruction is the inverse Haar and a back-projection
  (include/proto_aniso_rc.hpp:47-398).

Written in torch's idiom rather than the MXU's: AnisoRC's projection is
an integer ``index_add_`` of each block's Y values into its (angle, bin)
slot, exact whatever the TF32 setting; the back-projection gathers the
same bin index; the sketch's DCT is a broadcast multiply and sum in
float32, so no matmul precision setting reaches it.

Rounding parity with the C++:
* ``>> 1`` on int32 is an arithmetic shift, floor division as in C++.
* The median is ``std::nth_element(.., begin() + n/2, ..)``: the UPPER
  median for even n (``torch.median`` returns the lower one).
* The Radon bin is ``lround`` of a float32 sum; the tables are built on
  the host in float32 (``_rc_bin_tables``).
* The reconstruction's ``acc / hits`` is C++ integer division, which
  truncates toward zero.

Every entry point runs on ``device`` (default the current CUDA device,
see ``codec.resolve_device``); inputs move there.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import quant as Q
from .quant import f32

# Angle table, degrees (include/proto_aniso_rc.hpp:55).
RC_ANGLE_TABLE_DEG = (0.0, 22.5, 45.0, 67.5, 90.0, 112.5, 135.0, 157.5)


@dataclasses.dataclass(frozen=True)
class ProtoParams:
    """Haar-ternary + sketch parameters (include/proto_noentropy.hpp:40-48)."""
    tile: int = 8
    sketch_size: int = 32
    sketch_down: int = 256
    radial_bins: int = 8
    angle_bins: int = 8
    thresh: int = 6
    keep_ll_u8: bool = True


@dataclasses.dataclass(frozen=True)
class AnisoRCParams:
    """include/proto_aniso_rc.hpp:47-56."""
    block: int = 32
    angles: int = 8
    tern_thresh_z: float = 1.2
    keep_ll_u8: bool = True
    normalize_proj: bool = True


def _on(x, device) -> torch.Tensor:
    from ..codec import resolve_device
    return torch.as_tensor(x).to(resolve_device(device))


# ---------------------------------------------------------------------------
# integer-lifting Haar (single level), batched
# ---------------------------------------------------------------------------


def haar1d(v: torch.Tensor) -> torch.Tensor:
    """(..., L) -> int32 [approx | detail] along the last axis:
    a = (x0 + x1) >> 1, d = x0 - x1 (include/proto_noentropy.hpp:97-108)."""
    v = v.to(torch.int32)
    x0, x1 = v[..., 0::2], v[..., 1::2]
    return torch.cat([(x0 + x1) >> 1, x0 - x1], dim=-1)


def haar1d_inv(v: torch.Tensor) -> torch.Tensor:
    """x0 = a + d >> 1, x1 = a - (d - d >> 1)
    (include/proto_noentropy.hpp:110-120)."""
    v = v.to(torch.int32)
    L = v.shape[-1]
    a, d = v[..., :L // 2], v[..., L // 2:]
    x0 = a + (d >> 1)
    x1 = a - (d - (d >> 1))
    return torch.stack([x0, x1], dim=-1).reshape(*v.shape[:-1], L)


def haar2d(tiles: torch.Tensor) -> torch.Tensor:
    """(..., N, N): rows, then columns (include/proto_noentropy.hpp:124-139)."""
    return haar1d(haar1d(tiles).transpose(-1, -2)).transpose(-1, -2)


def haar2d_inv(tiles: torch.Tensor) -> torch.Tensor:
    """Columns, then rows (include/proto_noentropy.hpp:140-155)."""
    return haar1d_inv(haar1d_inv(tiles.transpose(-1, -2)).transpose(-1, -2))


# ---------------------------------------------------------------------------
# robust median/MAD ternarization (nth_element semantics)
# ---------------------------------------------------------------------------


def _upper_median(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The element at sorted index n // 2: std::nth_element's median, the
    UPPER one for even n."""
    return torch.sort(x, dim=dim).values.select(dim, x.shape[dim] // 2)


def robust_z(values: torch.Tensor, dim: int = -1, eps: float = 1e-6):
    """(v - med) / (1.4826 * (MAD + eps)), float32; the reference adds eps
    to the MAD before the factor (include/proto_noentropy.hpp:318-327,
    proto_aniso_rc.hpp:219-228).  The constants are float32, as the
    reference's float arithmetic."""
    v = values.to(torch.float32)
    med = _upper_median(v, dim).unsqueeze(dim)
    mad = _upper_median((v - med).abs(), dim).unsqueeze(dim) + f32(eps)
    return (v - med) / (f32(1.4826) * mad)


# ---------------------------------------------------------------------------
# T1: Haar ternary tiles
# ---------------------------------------------------------------------------


@functools.cache
def _detail_order_indices(n: int) -> np.ndarray:
    """Row-major flat indices of the non-LL coefficients of an NxN tile
    (include/proto_noentropy.hpp:207-215 iteration order)."""
    yy, xx = np.mgrid[0:n, 0:n]
    keep = ~((xx < n // 2) & (yy < n // 2))
    return (yy * n + xx)[keep].astype(np.int32)


def _pad_to_tiles_nn(rgb: torch.Tensor, n: int):
    """The reference pads by NN-resizing the whole image up to tile
    multiples (include/proto_noentropy.hpp:165-168), not by edge padding.
    -> (rgb, W, H)."""
    h, w = rgb.shape[0], rgb.shape[1]
    W = -(-w // n) * n
    H = -(-h // n) * n
    if (W, H) != (w, h):
        rgb = Q.resize_nn(rgb, H, W)
    return rgb, W, H


def _y_plane(rgb: torch.Tensor) -> torch.Tensor:
    return Q.rgb_to_ycbcr(rgb)[..., 0].to(torch.int32)


def _tiles(plane: torch.Tensor, n: int) -> torch.Tensor:
    """(H, W) -> (H/n * W/n, n, n), tiles in row-major order."""
    H, W = plane.shape
    return (plane.reshape(H // n, n, W // n, n).transpose(1, 2)
            .reshape(-1, n, n))


def _untile(tiles: torch.Tensor, tx: int, ty: int) -> torch.Tensor:
    """(ty * tx, n, n) -> (ty * n, tx * n)."""
    n = tiles.shape[-1]
    return tiles.reshape(ty, tx, n, n).transpose(1, 2).reshape(ty * n, tx * n)


def _haar_tiles_core(yplane: torch.Tensor, tile: int, thresh: int,
                     keep_ll_u8: bool):
    coef = haar2d(_tiles(yplane, tile)).reshape(-1, tile * tile)
    ll = coef[:, 0].clamp(0, 255).to(torch.uint8) if keep_ll_u8 else None
    idx = torch.as_tensor(_detail_order_indices(tile), dtype=torch.int64,
                          device=coef.device)
    det = coef[:, idx]
    trits = torch.where(det.abs() >= thresh, det.sign(), 0).to(torch.int8)
    return ll, trits.reshape(-1)


def proto_tile_haar_ternary(rgb, params: ProtoParams, device=None
                            ) -> Tuple[Optional[torch.Tensor], torch.Tensor,
                                       int, int]:
    """(h, w, 3) uint8 RGB -> (tile LL uint8 | None, balanced tile trits
    int8 flat, tiles_x, tiles_y), the tensors on ``device``
    (include/proto_noentropy.hpp:161-218)."""
    rgb, W, H = _pad_to_tiles_nn(_on(rgb, device), params.tile)
    ll, trits = _haar_tiles_core(_y_plane(rgb), params.tile, params.thresh,
                                 params.keep_ll_u8)
    return ll, trits, W // params.tile, H // params.tile


def proto_reconstruct_y_from_tiles(tile_ll, tile_trits, tiles_x: int,
                                   tiles_y: int, params: ProtoParams,
                                   device=None) -> torch.Tensor:
    """Approximate inverse: details at +-thresh, LL in coef[0], inverse
    Haar (include/proto_noentropy.hpp:334-366).  -> (H, W) uint8 Y plane
    on ``device``."""
    n = params.tile
    trits = _on(tile_trits, device)
    dev = trits.device
    idx = torch.as_tensor(_detail_order_indices(n), dtype=torch.int64,
                          device=dev)
    nt = tiles_x * tiles_y
    coef = torch.zeros((nt, n * n), dtype=torch.int32, device=dev)
    coef[:, idx] = trits.reshape(nt, -1).to(torch.int32) * params.thresh
    if params.keep_ll_u8 and tile_ll is not None:
        coef[:, 0] = _on(tile_ll, dev).to(torch.int32)
    rec = haar2d_inv(coef.reshape(nt, n, n)).clamp(0, 255).to(torch.uint8)
    return _untile(rec, tiles_x, tiles_y)


# ---------------------------------------------------------------------------
# T2: spectral sketch
# ---------------------------------------------------------------------------


@functools.cache
def _dct_basis(n: int) -> np.ndarray:
    """Orthonormal DCT-II basis B[k, i] = alpha_k cos(pi (2i+1) k / 2n),
    float32 like the reference (include/proto_noentropy.hpp:223-235)."""
    k = np.arange(n, dtype=np.float32)[:, None]
    i = np.arange(n, dtype=np.float32)[None, :]
    b = np.cos(np.float32(math.pi) * (2 * i + 1) * k / np.float32(2 * n))
    alpha = np.full((n, 1), math.sqrt(2.0 / n), dtype=np.float32)
    alpha[0, 0] = math.sqrt(1.0 / n)
    return (alpha * b).astype(np.float32)


@functools.cache
def _sketch_bin_onehot(n: int, rb: int, ab: int) -> np.ndarray:
    """(n*n, rb*ab) float32 bin membership; DC (0, 0) belongs to no bin
    (include/proto_noentropy.hpp:292-310 polar binning)."""
    cx = cy = (n - 1) / 2.0
    rmax = math.hypot(cx, cy)
    onehot = np.zeros((n * n, rb * ab), dtype=np.float32)
    for y in range(n):
        for x in range(n):
            if x == 0 and y == 0:
                continue
            X, Y = np.float32(x - cx), np.float32(y - cy)
            th = math.atan2(Y, X)
            if th < 0:
                th += 2 * math.pi
            r_i = min(rb - 1, int(math.hypot(X, Y) / (rmax + 1e-6) * rb))
            a_i = min(ab - 1, int(th / (2 * math.pi) * ab))
            onehot[y * n + x, r_i * ab + a_i] = 1.0
    return onehot


def _sketch_core(grid: torch.Tensor, size: int, rb: int, ab: int):
    dev = grid.device
    basis = torch.as_tensor(_dct_basis(size), device=dev)
    # F = basis @ grid @ basis.T as float32 multiplies and sums: no matmul,
    # so a TF32 setting of the caller cannot round the operands
    t = (basis[:, :, None] * grid[None, :, :]).sum(1)           # basis @ grid
    F = (t[:, None, :] * basis[None, :, :]).sum(-1)             # ... @ basis.T
    onehot = torch.as_tensor(_sketch_bin_onehot(size, rb, ab), device=dev)
    sums = (F.abs().reshape(-1, 1) * onehot).sum(0)
    counts = onehot.sum(0)
    vals = torch.where(counts > 0, sums / counts.clamp(min=1), 0.0)
    z = robust_z(vals)
    one = f32(1.0)
    return torch.where(z > one, 1, torch.where(z < -one, -1, 0)) \
        .to(torch.int8)


def proto_spectral_sketch(rgb, params: ProtoParams, device=None
                          ) -> torch.Tensor:
    """(h, w, 3) uint8 RGB -> (radial_bins * angle_bins,) balanced trits
    int8 on ``device`` (include/proto_noentropy.hpp:255-329)."""
    small = Q.resize_nn(_on(rgb, device), params.sketch_down,
                        params.sketch_down)
    yf = _y_plane(small).to(torch.float32) - f32(128.0)
    n = params.sketch_size
    bs = max(1, params.sketch_down // n)
    # block mean over bs x bs cells; with a square sketch_down the grid
    # divides exactly when n * bs == sketch_down
    hh = min(n * bs, params.sketch_down)
    g = yf[:hh, :hh].reshape(n, bs, n, bs).mean(dim=(1, 3))
    return _sketch_core(g, n, params.radial_bins, params.angle_bins)


# ---------------------------------------------------------------------------
# T3: AnisoRC (ridgelet/curvelet-lite)
# ---------------------------------------------------------------------------


def rc_proj_len_for_block(n: int) -> int:
    """2*ceil(N/sqrt(2)) + 1 (include/proto_aniso_rc.hpp:163-167)."""
    r = int(math.ceil(float(np.float32(n) * np.float32(0.70710678))))
    return 2 * r + 1


@functools.cache
def _rc_bin_tables(n: int, angles: int) -> Tuple[np.ndarray, np.ndarray]:
    """-> (onehot (A, n*n, PL) float32, counts (A, PL) int32).

    bin = lround_f32(xf*cos + yf*sin) + R, computed in float32 like the
    reference (include/proto_aniso_rc.hpp:149-202).
    """
    a_count = min(len(RC_ANGLE_TABLE_DEG), angles)
    pl = rc_proj_len_for_block(n)
    r = (pl - 1) // 2
    cx = cy = np.float32((n - 1) * 0.5)
    onehot = np.zeros((a_count, n * n, pl), dtype=np.float32)
    for ai in range(a_count):
        # every step rounds through float32, as the reference's
        # deg * (float)M_PI / 180.f then cosf/sinf: the residual
        # cos(90deg) ~ -4e-8 decides .5 ties of the bin index
        rad = np.float32(np.float32(RC_ANGLE_TABLE_DEG[ai])
                         * np.float32(math.pi)) / np.float32(180.0)
        c = np.float32(math.cos(float(rad)))
        s = np.float32(math.sin(float(rad)))
        for y in range(n):
            for x in range(n):
                # the sum is float32; lround's tie-break (+0.5, floor) is
                # done in double, as libm's lroundf (0.49999997f + 0.5
                # would round to 1.0f in float32)
                rho = float(np.float32(np.float32(x - cx) * c
                                       + np.float32(y - cy) * s))
                b = (int(math.floor(rho + 0.5)) if rho >= 0
                     else -int(math.floor(-rho + 0.5))) + r
                if 0 <= b < pl:
                    onehot[ai, y * n + x, b] = 1.0
    return onehot, onehot.sum(axis=1).astype(np.int32)


@functools.cache
def _rc_bins(n: int, angles: int) -> Tuple[np.ndarray, np.ndarray]:
    """-> (bin (A, n*n) int64, hits (n*n,) int32): each pixel's bin under
    each angle, PL where the pixel falls outside the projection (a slot
    that is dropped on encode and reads 0 on reconstruction), and the
    number of angles that see each pixel."""
    onehot, _counts = _rc_bin_tables(n, angles)
    inside = onehot.sum(axis=-1) > 0
    bins = np.where(inside, onehot.argmax(axis=-1), onehot.shape[-1])
    return bins.astype(np.int64), inside.sum(axis=0).astype(np.int32)


def _rc_encode_core(yplane: torch.Tensor, block: int, angles: int, zth: float,
                    keep_ll: bool, normalize: bool):
    n = block
    dev = yplane.device
    blocks = _tiles(yplane, n).reshape(-1, n * n)                # (B, n*n)
    ll = None
    if keep_ll:
        s = blocks.sum(-1)
        ll = torch.div(s + (n * n) // 2, n * n,
                       rounding_mode="floor").to(torch.uint8)

    bins, _hits = _rc_bins(n, angles)
    _onehot, counts = _rc_bin_tables(n, angles)
    a_used, pl = counts.shape
    bins = torch.as_tensor(bins, device=dev)
    # the Radon projection: each pixel's int32 value added into its bin,
    # one index_add_ per angle (exact: integer sums)
    proj = torch.zeros((blocks.shape[0], a_used, pl + 1), dtype=torch.int32,
                       device=dev)
    for a in range(a_used):
        proj[:, a].index_add_(1, bins[a], blocks)
    proj = proj[..., :pl]
    if normalize:
        cnt = torch.as_tensor(counts, device=dev)[None]          # (1, A, PL)
        proj = torch.where(cnt > 0, torch.div(proj + cnt // 2, cnt.clamp(min=1),
                                              rounding_mode="floor"), proj)
    if pl % 2:  # pad to even by repeating the last sample (hpp:306)
        proj = torch.cat([proj, proj[..., -1:]], dim=-1)
    sig = haar1d(proj)
    det = sig[..., sig.shape[-1] // 2:]                           # (B, A, hlen)

    absd = det.abs().to(torch.float32)
    med = _upper_median(absd)[..., None]
    mad = _upper_median((absd - med).abs())[..., None] + f32(1e-6)
    z = (absd - med) / (f32(1.4826) * mad)
    trits = torch.where(z > f32(zth), det.sign(), 0).to(torch.int8)
    return ll, trits.reshape(-1)


@dataclasses.dataclass
class AnisoRCArtifacts:
    """include/proto_aniso_rc.hpp:60-84; ``block_ll`` (uint8) and ``trits``
    (balanced int8) are tensors on the device that encoded them."""
    W: int
    H: int
    N: int
    blocks_x: int
    blocks_y: int
    proj_len: int
    angles_used: int
    trits_per_block: int
    block_ll: Optional[torch.Tensor]
    trits: torch.Tensor


def proto_aniso_rc_encode(rgb, params: AnisoRCParams, device=None
                          ) -> AnisoRCArtifacts:
    """(h, w, 3) uint8 RGB -> AnisoRCArtifacts on ``device``
    (include/proto_aniso_rc.hpp:235-315)."""
    rgb, W, H = _pad_to_tiles_nn(_on(rgb, device), params.block)
    ll, trits = _rc_encode_core(
        _y_plane(rgb), params.block, params.angles,
        float(params.tern_thresh_z), params.keep_ll_u8, params.normalize_proj)
    pl = rc_proj_len_for_block(params.block)
    a_used = min(len(RC_ANGLE_TABLE_DEG), params.angles)
    # after even-padding there are (PL+1)//2 details per (block, angle); the
    # reference's metadata says PL/2 (hpp:280), A short for odd PL: the
    # actual stream length is kept, as the JAX package keeps it
    return AnisoRCArtifacts(
        W=W, H=H, N=params.block, blocks_x=W // params.block,
        blocks_y=H // params.block, proj_len=pl, angles_used=a_used,
        trits_per_block=a_used * ((pl + 1) // 2), block_ll=ll, trits=trits)


def _rc_reconstruct_core(trits: torch.Tensor, block_ll, n: int, angles: int,
                         pl: int, t: int) -> torch.Tensor:
    dev = trits.device
    hlen = (pl + 1) // 2                  # even-padded signal length // 2
    B = trits.numel() // (angles * hlen)
    sig_len = pl + (pl % 2)
    sig = torch.zeros((B, angles, sig_len), dtype=torch.int32, device=dev)
    sig[..., sig_len // 2:] = trits.reshape(B, angles, hlen).to(torch.int32) * t
    rec = haar1d_inv(sig)[..., :pl]
    # slot PL reads 0: the pixels an angle does not see
    rec = torch.nn.functional.pad(rec, (0, 1))                   # (B, A, PL+1)
    bins, hits = _rc_bins(n, angles)
    bins = torch.as_tensor(bins, device=dev)
    acc = torch.zeros((B, n * n), dtype=torch.int32, device=dev)
    for a in range(angles):                    # back-projection: a gather
        acc += rec[:, a].index_select(1, bins[a])
    hits = torch.as_tensor(hits, device=dev)
    # C++ integer division truncates toward zero (acc may be negative)
    v = torch.where(hits > 0, torch.div(acc, hits.clamp(min=1),
                                        rounding_mode="trunc"), 0)
    dc = (block_ll.to(torch.int32)[:, None] if block_ll is not None
          else torch.full((B, 1), 128, dtype=torch.int32, device=dev))
    return (dc + v).clamp(0, 255).to(torch.uint8)


def proto_aniso_rc_reconstruct(art: AnisoRCArtifacts, params: AnisoRCParams,
                               t: int = 20, device=None) -> torch.Tensor:
    """Approximate QA reconstruction -> (H, W) uint8 Y plane on ``device``
    (include/proto_aniso_rc.hpp:326-388)."""
    trits = _on(art.trits, device)
    ll = None if art.block_ll is None else art.block_ll.to(trits.device)
    rec = _rc_reconstruct_core(trits, ll, art.N, art.angles_used,
                               art.proj_len, t)
    return _untile(rec.reshape(-1, art.N, art.N), art.blocks_x, art.blocks_y)


def psnr_y(a, b) -> float:
    """QA metric on the host (src/minitest_aniso_rc.cpp:21-27); arrays or
    tensors on any device."""
    a, b = (np.asarray(torch.as_tensor(x).cpu(), dtype=np.float64)
            for x in (a, b))
    mse = np.mean((a - b) ** 2)
    if mse <= 0:
        return float("inf")
    return 10.0 * math.log10(255.0 * 255.0 / mse)
