"""Multi-device runs over ``torch.distributed``: the JAX package's
parallel/mesh.py on ranks.

Every rank runs the same call.  Each function takes the global input on
every rank, as the JAX function takes the global array, moves only its
own shard to its device, and returns its own rows and the global
reductions: outputs stay sharded, and ``gather`` all-gathers a sharded
output into the global array.  Only flags, reductions, the pipeline's
stage handoff and ``gather`` cross ranks; flags travel as uint8 or int32,
never bool.

* Frame-DP (``encode_frames_dp``, ``decode_frames_dp``,
  ``roundtrip_step_dp``): each rank codes ``B / size`` whole frames with
  the one-frame codec (``codec_for(cfg, device, n_raw)``); the decode is
  body-only, as the reference's (headers are not validated there).
* Superframe-DP of one large frame (``roundtrip_superframes_dp``): each
  rank round-trips its contiguous superframes through its codec's stream
  roundtrip, ``sf_batch`` at a time.
* The fused two-phase decode under superframe-DP
  (``decode_superframes_fused_dp``): a check decode (K1) on each rank's
  superframes, the flags all-gathered, one global stable argsort, and
  each rank repairs the window entries it holds through the paged
  corrector (K2 and the RS(26,18) header chain).  No superframe moves.
  Unlike the reference, header words are validated and repaired (the
  result equals the single-device fused decode), and a superframe count
  that is no multiple of the mesh size raises.
* Two-stage pipeline (``roundtrip_pipeline_pp`` on ``make_mesh_pp``):
  stage 0 encodes microbatch t while stage 1 decodes t - 1; the wire goes
  to the peer stage by ``broadcast`` in the stage pair's group (gloo
  aborts on ``send``/``recv`` of CUDA tensors; both backends take a
  ``broadcast``), and stage 1's results reach stage 0 the same way.
* Word-stream sharding (``encode_stream_sharded``): each rank encodes a
  contiguous range of the profile's body rows, 26 rows a codeword block,
  across every band, from only the RAW words those rows read; rank 0 also
  writes the 6 header rows.

A mesh is made on every rank of an initialised process group
(``parallel.launch.spawn`` starts such ranks) from its first
``n_devices`` ranks; a rank outside the mesh gets None.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..codec import codec_for
from ..config import EncoderConfig, NUM_BANDS
from ..ops import encode as encode_mod
from ..ops import pipeline, rs
from ..ops.pipeline import HEADER_WORDS
from . import launch


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a mesh: ``group`` holds the mesh's ranks,
    ``rank`` and ``size`` are this rank's index in it and its size,
    ``device`` this rank's device; ``axes`` name the axes, ``shape``
    gives their sizes, ``coords`` this rank's index along each, and
    ``groups`` the group of the ranks that differ from this one along
    that axis alone."""

    group: object
    rank: int
    size: int
    device: torch.device
    axes: tuple
    shape: dict
    coords: dict
    groups: dict


def _mesh_ranks(n_devices):
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs an initialised process group: run the ranks with "
            "parallel.launch.spawn, or call "
            "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    n = n_devices or world
    if not 0 < n <= world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    return n, group, dist.get_rank()


def make_mesh(n_devices: int | None = None,
              axis: str = "data") -> Mesh | None:
    """A 1-D mesh of the first ``n_devices`` ranks (default: all), on this
    rank's device (``launch.rank_device``: the one ``spawn`` gave it, else
    the current CUDA device).  Every rank calls it; None outside the
    mesh."""
    dev = launch.rank_device()
    n, group, rank = _mesh_ranks(n_devices)
    if rank >= n:
        return None
    return Mesh(group, rank, n, dev, (axis,), {axis: n}, {axis: rank},
                {axis: group})


def make_mesh_pp(n_devices: int | None = None, stage_axis: str = "stage",
                 data_axis: str = "data") -> Mesh | None:
    """A (stage=2, data=n/2) mesh of the first ``n_devices`` ranks, laid
    out as the reference's ``reshape(2, n // 2)``: rank r is stage
    r // (n/2), data index r % (n/2).  An odd count raises.  Every rank
    calls it (it makes every stage's and every pair's group); None outside
    the mesh."""
    dev = launch.rank_device()
    n, group, rank = _mesh_ranks(n_devices)
    if n % 2:
        raise ValueError(f"a PP mesh needs an even rank count, got {n}")
    nd = n // 2
    stage_groups = [dist.new_group(list(range(s * nd, (s + 1) * nd)))
                    for s in range(2)]
    pair_groups = [dist.new_group([d, nd + d]) for d in range(nd)]
    if rank >= n:
        return None
    s, d = divmod(rank, nd)
    return Mesh(group, rank, n, dev, (stage_axis, data_axis),
                {stage_axis: 2, data_axis: nd}, {stage_axis: s, data_axis: d},
                {stage_axis: pair_groups[d], data_axis: stage_groups[s]})


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _all_gather(x: torch.Tensor, group) -> list:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


def gather(mesh: Mesh, x: torch.Tensor, dim: int = 0,
           axis: str | None = None) -> torch.Tensor:
    """Every rank's shard of ``x`` (split along ``dim``; shards may differ
    in length) all-gathered into the global tensor on this rank's device,
    over the whole mesh or, with ``axis``, over the ranks along that axis.
    Bool shards travel as uint8."""
    group = mesh.group if axis is None else mesh.groups[axis]
    is_bool = x.dtype == torch.bool
    x = x.to(mesh.device).movedim(dim, 0)
    if is_bool:
        x = x.to(torch.uint8)
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=mesh.device)
    sizes = torch.cat(_all_gather(n, group)).tolist()
    if max(sizes) > x.shape[0]:
        x = torch.cat([x, x.new_zeros((max(sizes) - x.shape[0],
                                       *x.shape[1:]))])
    out = torch.cat([p[:s] for p, s in zip(_all_gather(x, group), sizes)])
    out = out.movedim(0, dim)
    return out.to(torch.bool) if is_bool else out


def all_ok(ok, mesh: Mesh) -> torch.Tensor:
    """The global AND of every rank's flags (a MIN all-reduce of int32):
    a 0-d bool tensor on this rank's device."""
    v = torch.as_tensor(ok, device=mesh.device).all().to(torch.int32)
    v = v.reshape(1)
    dist.all_reduce(v, op=dist.ReduceOp.MIN, group=mesh.group)
    return v[0].to(torch.bool)


# ---------------------------------------------------------------------------
# frame-DP
# ---------------------------------------------------------------------------


def _rows(n: int, size: int, index: int, what: str) -> slice:
    if n % size:
        raise ValueError(f"{what}: {n} is not a multiple of the "
                         f"{size} ranks it is split over")
    per = n // size
    return slice(index * per, (index + 1) * per)


def _local(x, rows: slice, device) -> torch.Tensor:
    """Rows ``rows`` of a global input (numpy or a tensor on any device)
    as int8 on ``device``: only those rows move."""
    return torch.as_tensor(x[rows]).to(device, torch.int8)


def _body_paged(planes: torch.Tensor, codec) -> tuple:
    """Body-only paged decode of wire planes (n, 9, 6 + H) with ``codec``'s
    tables -> (RAW words (n, n_out, 9), ok (n,))."""
    raw, ok = pipeline.paged_body(planes[:, :, HEADER_WORDS:], codec.dlayout,
                                  codec.tables())
    return raw.transpose(1, 2), ok


def encode_frames_dp(raw_frames, cfg: EncoderConfig, mesh: Mesh):
    """Encode a batch of RAW frames (B, n_raw, 9), frame-sharded: this
    rank's (B / size, total, 9) profile words, headers included (the
    one-frame codec's, frame 0).  B must divide by the mesh size."""
    B, n_raw = raw_frames.shape[:2]
    rows = _rows(B, mesh.size, mesh.rank, "encode_frames_dp: the frame count")
    codec = codec_for(cfg, mesh.device, n_raw)
    return codec.encode(_local(raw_frames, rows, mesh.device)).transpose(1, 2)


def decode_frames_dp(words, cfg: EncoderConfig, mesh: Mesh,
                     rs_mode: str = "paged"):
    """Decode a batch of profile frames (B, total, 9), frame-sharded, body
    only, under ``rs_mode`` (check, paged, full, none): this rank's (raw
    (B / size, n_out, 9), ok (B / size,)) and the global ``all_ok``."""
    B, total = words.shape[:2]
    rows = _rows(B, mesh.size, mesh.rank, "decode_frames_dp: the frame count")
    dlayout, T = pipeline._body_decoder_tables(cfg, total - HEADER_WORDS,
                                               mesh.device)
    body = _local(words, rows, mesh.device)[:, HEADER_WORDS:] \
        .transpose(1, 2).contiguous()
    raw, ok = pipeline.body_decoder(rs_mode)(body, dlayout, T)
    return raw.transpose(1, 2), ok, all_ok(ok, mesh)


def roundtrip_step_dp(raw_frames, cfg: EncoderConfig, mesh: Mesh):
    """Encode then body-only paged decode of a frame batch (B, n_raw, 9),
    frame-sharded: this rank's decoded frames (B / size, n_out, 9) and the
    global ok."""
    B, n_raw = raw_frames.shape[:2]
    rows = _rows(B, mesh.size, mesh.rank, "roundtrip_step_dp: the frame count")
    codec = codec_for(cfg, mesh.device, n_raw)
    raw, ok = _body_paged(codec.encode(_local(raw_frames, rows, mesh.device)),
                          codec)
    return raw, all_ok(ok, mesh)


# ---------------------------------------------------------------------------
# superframe-DP
# ---------------------------------------------------------------------------


def roundtrip_superframes_dp(raw_words, cfg: EncoderConfig, mesh: Mesh,
                             sf_batch: int = 4):
    """Superframe-sharded encode and paged decode of ONE large frame of
    RAW words (n, 9): the superframe count is rounded up to a multiple of
    the mesh size and the tail padded with zero words, as the reference
    pads it; each rank round-trips its contiguous superframes
    (``SuperframeCodec.roundtrip``, ``sf_batch`` at a time).  Returns this
    rank's decoded RAW words (n_sf / size * superframe_words, 9) and the
    global ok; ``gather`` and ``[:n]`` give the frame."""
    n = int(raw_words.shape[0])
    sf = cfg.superframe_words
    n_sf = -(-n // sf)
    n_sf = -(-n_sf // mesh.size) * mesh.size
    per = n_sf // mesh.size
    lo, hi = mesh.rank * per * sf, (mesh.rank + 1) * per * sf
    local = _local(raw_words, slice(lo, min(hi, n)), mesh.device)
    local = torch.nn.functional.pad(local, (0, 0, 0, hi - lo - local.shape[0]))
    codec = codec_for(cfg, mesh.device)
    out, ok = codec.roundtrip(local.view(per, sf, NUM_BANDS), rs_mode="paged",
                              sf_batch=sf_batch)
    return out[:, :, :sf].transpose(1, 2).reshape(-1, NUM_BANDS), \
        all_ok(ok, mesh)


def decode_superframes_fused_dp(words, cfg: EncoderConfig, mesh: Mesh,
                                repair_cap: int = 4):
    """The fused two-phase decode of a superframe-sharded stream of profile
    words (n_sf, total, 9), n_sf a multiple of the mesh size (else
    ValueError): each rank check-decodes its superframes (K1, headers
    byte-compared), the flags are all-gathered, the first ``repair_cap``
    of a global stable argsort (flagged first, clamped to n_sf) form the
    repair window, and each rank repairs the entries it holds through the
    paged corrector (K2; headers through the RS(26,18) chain).  ok is the
    global AND of the repairs, False when more than the window was
    flagged.  Returns this rank's (raw (n_sf / size, n_out, 9), ok); equal
    to the single-device ``decode_stream_superframes(strategy="fused")``."""
    if repair_cap <= 0:
        raise ValueError(f"repair_cap must be positive, got {repair_cap}")
    n_sf = int(words.shape[0])
    if n_sf % mesh.size:
        raise ValueError(
            f"decode_superframes_fused_dp: n_sf={n_sf} superframes must be a "
            f"multiple of the mesh size {mesh.size}; pad the stream")
    rows = _rows(n_sf, mesh.size, mesh.rank, "n_sf")
    codec = codec_for(cfg, mesh.device)
    if tuple(words.shape[1:]) != (codec.layout.total_words, NUM_BANDS):
        raise ValueError(f"words (n_sf, {codec.layout.total_words}, 9) for "
                         f"this config, got {tuple(words.shape)}")
    local = _local(words, rows, mesh.device).transpose(1, 2).contiguous()
    raw, ok_sf = codec.check(local)
    flags = gather(mesh, ok_sf)
    nbad = int((~flags).sum())
    idx = torch.argsort(flags.to(torch.uint8), stable=True)[:repair_cap]
    mine = idx[(idx >= rows.start) & (idx < rows.stop)] - rows.start
    ok_fix = True
    if mine.numel():
        fix, ok_f = codec.paged(local[mine], sf_batch=repair_cap)
        raw[mine] = fix
        ok_fix = ok_f
    ok = all_ok(ok_fix, mesh) & (nbad <= idx.numel())
    return raw.transpose(1, 2), ok


# ---------------------------------------------------------------------------
# two-stage pipeline
# ---------------------------------------------------------------------------


def roundtrip_pipeline_pp(raw_frames, cfg: EncoderConfig, mesh: Mesh,
                          stage_axis: str = "stage", data_axis: str = "data",
                          wire_damage=None):
    """Two-stage pipeline over the codec's stages, data-parallel within a
    stage, on a ``make_mesh_pp`` mesh.

    raw_frames: (T, db, n_raw, 9), T microbatches of db frames, db a
    multiple of the data axis (else ValueError).  At step t stage-0 rank d
    encodes its db / ndata frames of microbatch t, adds ``wire_damage``
    ((T, db, total, 9) GF(27) deltas, mod 27) on the link and hands the
    wire to stage-1 rank d, which meanwhile decodes microbatch t - 1 (body
    only, paged); one drain step decodes the last.  Both stages return
    this data index's (decoded (T, db / ndata, n_out, 9), ok
    (T, db / ndata)), stage 1's results broadcast to stage 0."""
    T_, db, n_raw = raw_frames.shape[:3]
    nd = mesh.shape[data_axis]
    if db % nd:
        raise ValueError(f"roundtrip_pipeline_pp: the microbatch size {db} "
                         f"must divide by the data axis ({nd})")
    stage, d = mesh.coords[stage_axis], mesh.coords[data_axis]
    pair, src0, src1 = mesh.groups[stage_axis], d, nd + d
    rows = _rows(db, nd, d, "the microbatch size")
    dev = mesh.device
    codec = codec_for(cfg, dev, n_raw)
    total, n_out = codec.layout.total_words, codec.dlayout.n_out_words
    if wire_damage is not None and tuple(wire_damage.shape) != (
            T_, db, total, NUM_BANDS):
        raise ValueError(f"wire_damage must be {(T_, db, total, NUM_BANDS)}, "
                         f"got {tuple(wire_damage.shape)}")
    dbl = db // nd
    outs = torch.zeros((T_, dbl, n_out, NUM_BANDS), dtype=torch.int8,
                       device=dev)
    oks = torch.zeros((T_, dbl), dtype=torch.uint8, device=dev)
    inflight = None
    for t in range(T_ + 1):
        wire = None
        if stage == 0 and t < T_:
            wire = codec.encode(_local(raw_frames[t], rows, dev))
            if wire_damage is not None:
                dmg = _local(wire_damage[t], rows, dev).transpose(1, 2)
                wire = torch.remainder(wire.to(torch.int16) + dmg, 27) \
                    .to(torch.int8)
        if stage == 1 and t > 0:
            raw, ok = _body_paged(inflight, codec)
            outs[t - 1], oks[t - 1] = raw, ok.to(torch.uint8)
        if t < T_:
            if stage == 1:
                wire = torch.empty((dbl, NUM_BANDS, total), dtype=torch.int8,
                                   device=dev)
            wire = wire.contiguous()
            dist.broadcast(wire, src=src0, group=pair)
            inflight = wire
    dist.broadcast(outs, src=src1, group=pair)
    dist.broadcast(oks, src=src1, group=pair)
    return outs, oks.to(torch.bool)


# ---------------------------------------------------------------------------
# word-stream sharding
# ---------------------------------------------------------------------------


def body_rows(H: int, size: int, index: int) -> tuple:
    """The body rows [lo, hi) of rank ``index`` of ``size``: whole 26-row
    blocks, split as evenly as they go, the last block cut at H."""
    nb = -(-H // rs.N)
    return (rs.N * (index * nb // size),
            min(rs.N * ((index + 1) * nb // size), H))


def encode_stream_sharded(raw_words, cfg: EncoderConfig, mesh: Mesh):
    """One frame of RAW words (n, 9) encoded as one profile (6 + H, 9),
    sharded by output rows: this rank's body rows ``body_rows(H, size,
    rank)``, with the 6 header rows first on rank 0.  ``gather`` gives
    ``encode_profile_from_raw(raw_words, cfg)`` for every layout (P5 and
    the beacon included)."""
    layout = pipeline.build_encode_layout(cfg, int(raw_words.shape[0]))
    lo, hi = body_rows(layout.geom.H, mesh.size, mesh.rank)
    rows = encode_mod.encode_rows(raw_words, layout, lo, hi, mesh.device)
    if mesh.rank == 0:
        hdr = torch.as_tensor(layout.header_words, device=mesh.device)
        rows = torch.cat([hdr, rows])
    return rows
