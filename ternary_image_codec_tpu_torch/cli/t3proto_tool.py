"""t3proto_tool — CLI for .t3proto prototype streams.

Subcommand/flag parity with src/t3proto_tool.cpp:5-33:
  encode --in img.png --out s.t3proto --profile {haar|rc}
         [--no-pack] [--no-balanced]
         [--haar-tile 8 --haar-thresh 6]
         [--rc-block 32 --rc-angles 8 --rc-z 1.2]
  info   s.t3proto [--json]
  export-unb s.t3proto --out tri_unb.bin
  export-bal s.t3proto --out tri_bal.bin
  repack in.t3proto --to {packed|balanced} --out out.t3proto
         [--keep-balanced] [--keep-packed] [--n-trits N] [--guess]
         [--strict] [--force-exact N]
  cat    --out merged.t3proto a.t3proto b.t3proto ...
         [--require-balanced] [--require-packed]

Every subcommand takes ``--device`` (default: the current CUDA device);
``encode`` runs its prototype there.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from .. import profiles as PR
from ..codec import resolve_device
from ..io import legacy_containers as LC
from ..io.containers import ContainerError
from . import add_device_arg


def _pname(p: LC.ProtoProfile) -> str:
    return {LC.ProtoProfile.HAAR_TERNARY: "HaarTernary",
            LC.ProtoProfile.ANISO_RC: "AnisoRC"}.get(p, "None")


def meta_upsert_counts(meta: str, ntr: int, pbytes: int, tail: int,
                       exact: bool) -> str:
    """Insert-or-update the counts block inside a meta JSON string
    (src/t3proto_tool.cpp:201-268 behavior, JSON-library based)."""
    try:
        m = json.loads(meta) if meta.strip() else {}
        if not isinstance(m, dict):
            m = {"meta": m}
    except json.JSONDecodeError:
        m = {"raw_meta": meta}
    counts = m.setdefault("counts", {})
    counts["n_trits"] = ntr
    counts["tail_trits"] = max(0, tail)
    counts["packed_bytes"] = pbytes
    counts["exact_n_trits"] = bool(exact)
    return json.dumps(m, separators=(",", ":"))


def _cmd_encode(args) -> int:
    from ..io import image as I
    profile = {"haar": LC.ProtoProfile.HAAR_TERNARY,
               "rc": LC.ProtoProfile.ANISO_RC}.get(args.profile.lower())
    if profile is None:
        print(f"unknown profile: {args.profile}", file=sys.stderr)
        return 2
    cfg = PR.ProtoConfig(
        profile=profile, haar_tile=args.haar_tile,
        haar_thresh=args.haar_thresh, rc_block=args.rc_block,
        rc_angles=args.rc_angles, rc_tern_z=args.rc_z,
        pack_base243=not args.no_pack)
    try:
        rgb = I.load_image_rgb8(args.infile)
    except (OSError, ValueError) as e:
        print(f"cannot load: {args.infile} ({e})", file=sys.stderr)
        return 1
    bal, packed, meta = PR.encode_prototype_ternary(rgb, cfg, args.device)
    n_bytes = packed.size if packed is not None else 0
    meta = meta_upsert_counts(meta, bal.size, n_bytes, bal.size % 5, True)
    LC.t3proto_write(args.out, profile, rgb.shape[1], rgb.shape[0],
                     None if args.no_balanced else bal, packed, meta)
    print(f"OK: wrote {args.out}  (trits={bal.size}, bytes={n_bytes})")
    return 0


def _cmd_info(args) -> int:
    # header peek only -- O(header+meta), payload never read (matches the
    # reference's header-peek info path, src/t3proto_tool.cpp)
    try:
        prof, w, h, flags, n_trits, n_bytes, meta = LC.t3proto_peek(args.path)
    except (ContainerError, OSError) as e:
        print(f"read failed: {args.path} ({e})", file=sys.stderr)
        return 1
    ntr = n_trits if flags & LC.F_BAL_PRESENT else 0
    nby = n_bytes if flags & LC.F_PACK_PRESENT else 0
    if args.json:
        print(json.dumps({"t3proto": {
            "file": args.path, "profile": _pname(prof), "W": w, "H": h,
            "trits": int(ntr), "bytes": int(nby),
            "meta_len": len(meta)}}, indent=2))
    else:
        print(f"== .t3proto ==\nfile: {args.path}\nprofile: {_pname(prof)}\n"
              f"dims: {w} x {h}\ntrits: {ntr}  bytes(pack): {nby}\n"
              f"meta_len: {len(meta)}")
    return 0


def _cmd_export(args, balanced: bool) -> int:
    try:
        _prof, _w, _h, bal, _packed, _meta = LC.t3proto_read(args.path)
    except (ContainerError, OSError) as e:
        print(f"read failed: {args.path} ({e})", file=sys.stderr)
        return 1
    if bal is None or bal.size == 0:
        print("no balanced trits in file.", file=sys.stderr)
        return 1
    data = (bal.astype(np.int8) if balanced
            else (np.clip(bal, -1, 1) + 1).astype(np.uint8))
    with open(args.out, "wb") as f:
        f.write(data.tobytes())
    kind = "balanced" if balanced else "unbalanced"
    print(f"OK: wrote {kind} trits to {args.out} ({bal.size} bytes)")
    return 0


def _cmd_repack(args) -> int:
    try:
        prof, w, h, bal, packed, meta = LC.t3proto_read(args.infile)
    except (ContainerError, OSError) as e:
        print(f"read failed: {args.infile} ({e})", file=sys.stderr)
        return 1
    to = args.to.lower()
    n_trits_opt = args.n_trits
    strict = args.strict
    if args.force_exact is not None:  # implies --to balanced --strict
        n_trits_opt = args.force_exact
        strict = True
        to = "balanced"
    if to == "packed":
        if packed is None or packed.size == 0:
            if bal is None or bal.size == 0:
                print("nothing to pack: no balanced trits in input.",
                      file=sys.stderr)
                return 1
            packed = PR.pack_base243_from_balanced(bal)
        nb = bal.size if bal is not None else 0
        meta = meta_upsert_counts(meta, nb, packed.size, nb % 5, True)
        LC.t3proto_write(args.out, prof, w, h,
                         bal if args.keep_balanced else None, packed, meta)
        print(f"OK: repacked -> packed (bytes={packed.size})")
        return 0
    if to == "balanced":
        exact = False
        ntr = 0
        if args.force_exact is not None:
            ntr, exact = n_trits_opt, True
        elif bal is not None and bal.size:
            ntr, exact = bal.size, True
        else:
            # inference chain (src/t3proto_tool.cpp:616-672)
            c = LC.meta_find_int(meta, "n_trits")
            if c:
                ntr = c
                tail = LC.meta_find_int(meta, "tail_trits")
                pb = LC.meta_find_int(meta, "packed_bytes")
                exact = (tail is not None or
                         (pb is not None and ntr % 5 == 0 and ntr == pb * 5))
            if ntr == 0:
                lt = LC.meta_find_int(meta, "len_tiles") or 0
                ls = LC.meta_find_int(meta, "len_sketch") or 0
                if lt + ls > 0:
                    ntr, exact = lt + ls, True
            if ntr == 0:
                tpb = LC.meta_find_int(meta, "trits_per_block")
                blk = LC.meta_find_int(meta, "block")
                if tpb and blk:
                    ntr = tpb * (-(-w // blk)) * (-(-h // blk))
                    exact = ntr > 0
            if ntr == 0 and args.guess and packed is not None:
                ntr, exact = packed.size * 5, False
            if n_trits_opt:
                ntr, exact = n_trits_opt, True
            if ntr == 0:
                print("cannot infer number of trits. Use --n-trits N or "
                      "--guess.", file=sys.stderr)
                return 1
        if strict and not exact:
            print("--strict: exact_n_trits is not guaranteed for this file.",
                  file=sys.stderr)
            return 1
        if bal is None or bal.size == 0:
            bal = PR.unpack_base243_to_balanced(packed, ntr)
        pbytes = packed.size if packed is not None else 0
        meta = meta_upsert_counts(meta, bal.size, pbytes, bal.size % 5, exact)
        LC.t3proto_write(args.out, prof, w, h, bal,
                         packed if args.keep_packed else None, meta)
        print(f"OK: repacked -> balanced (trits={bal.size}, "
              f"exact={'true' if exact else 'false'})")
        return 0
    print("--to must be 'packed' or 'balanced'", file=sys.stderr)
    return 2


def _cmd_cat(args) -> int:
    prof_all, w_all, h_all = None, 0, 0
    have_bal, have_pack = True, True
    bal_cat, pack_cat, parts = [], [], []
    for i, path in enumerate(args.inputs):
        try:
            prof, w, h, bal, packed, _meta = LC.t3proto_read(path)
        except (ContainerError, OSError) as e:
            print(f"read failed: {path} ({e})", file=sys.stderr)
            return 1
        if i == 0:
            prof_all, w_all, h_all = prof, w, h
        elif (prof, w, h) != (prof_all, w_all, h_all):
            print(f"incompatible file: {path} (profile/dims differ)",
                  file=sys.stderr)
            return 1
        nb = bal.size if bal is not None else 0
        npk = packed.size if packed is not None else 0
        have_bal &= nb > 0
        have_pack &= npk > 0
        if nb:
            bal_cat.append(bal)
        if npk:
            pack_cat.append(packed)
        parts.append({"file": path, "trits": int(nb), "bytes": int(npk)})
    if args.require_balanced and not have_bal:
        print("--require-balanced: at least one input missing balanced "
              "trits.", file=sys.stderr)
        return 1
    if args.require_packed and not have_pack:
        print("--require-packed: at least one input missing packed bytes.",
              file=sys.stderr)
        return 1
    bal = np.concatenate(bal_cat) if have_bal and bal_cat else None
    packed = np.concatenate(pack_cat) if have_pack and pack_cat else None
    meta = json.dumps({"concat": parts})
    LC.t3proto_write(args.out, prof_all, w_all, h_all, bal, packed, meta)
    nb = bal.size if bal is not None else 0
    npk = packed.size if packed is not None else 0
    print(f"OK: concatenated {len(args.inputs)} files -> {args.out}  "
          f"(trits={nb}, bytes={npk})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="t3proto_tool",
                                 description=".t3proto prototype stream tool")
    dev = argparse.ArgumentParser(add_help=False)
    add_device_arg(dev)
    sub = ap.add_subparsers(dest="cmd", required=True)

    e = sub.add_parser("encode", parents=[dev])
    e.add_argument("--in", dest="infile", required=True)
    e.add_argument("--out", required=True)
    e.add_argument("--profile", required=True)
    e.add_argument("--no-pack", action="store_true")
    e.add_argument("--no-balanced", action="store_true")
    e.add_argument("--haar-tile", type=int, default=8)
    e.add_argument("--haar-thresh", type=int, default=6)
    e.add_argument("--rc-block", type=int, default=32)
    e.add_argument("--rc-angles", type=int, default=8)
    e.add_argument("--rc-z", type=float, default=1.2)

    i = sub.add_parser("info", parents=[dev])
    i.add_argument("path")
    i.add_argument("--json", action="store_true")

    for name in ("export-unb", "export-bal"):
        x = sub.add_parser(name, parents=[dev])
        x.add_argument("path")
        x.add_argument("--out", required=True)

    r = sub.add_parser("repack", parents=[dev])
    r.add_argument("infile")
    r.add_argument("--to", default="")
    r.add_argument("--out", required=True)
    r.add_argument("--keep-balanced", action="store_true")
    r.add_argument("--keep-packed", action="store_true")
    r.add_argument("--n-trits", type=int, default=0)
    r.add_argument("--guess", action="store_true")
    r.add_argument("--strict", action="store_true")
    r.add_argument("--force-exact", type=int, default=None)

    c = sub.add_parser("cat", parents=[dev])
    c.add_argument("--out", required=True)
    c.add_argument("--require-balanced", action="store_true")
    c.add_argument("--require-packed", action="store_true")
    c.add_argument("inputs", nargs="+")

    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)
    if args.cmd == "encode":
        return _cmd_encode(args)
    if args.cmd == "info":
        return _cmd_info(args)
    if args.cmd == "export-unb":
        return _cmd_export(args, balanced=False)
    if args.cmd == "export-bal":
        return _cmd_export(args, balanced=True)
    if args.cmd == "repack":
        return _cmd_repack(args)
    if args.cmd == "cat":
        return _cmd_cat(args)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
