"""Command-line interface: bake, stats, dump-images, info, viewer, bench.

The port's copy of `omm_tpu/cli.py`.  Headless replacement for the
reference viewer tool's workflows (tools/viewer/viewer_app.cpp):
operates on serialized .bin blobs (reference-SDK compatible) and on PNG
alpha textures.  The subcommands that bake run on the CUDA card unless
given `--device cpu`.

    python -m omm_tpu_torch.cli bake --texture alpha.png --out result.bin
    python -m omm_tpu_torch.cli stats result.bin
    python -m omm_tpu_torch.cli dump-images input.bin --out-dir overlays/
    python -m omm_tpu_torch.cli info blob.bin
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np


def _load_alpha(path: str, channel: int = 3) -> np.ndarray:
    from PIL import Image
    img = np.asarray(Image.open(path))
    if img.ndim == 2:
        plane = img
    else:
        c = min(channel, img.shape[2] - 1)
        plane = img[..., c]
    return plane.astype(np.uint8)


#: where the subcommands that bake run: the card (the default) or the
#: port's plain path on the CPU
DEVICES = ("cuda", "cpu")


def _default_quad():
    tc = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.float32)
    ib = np.array([0, 1, 2, 3, 1, 2], np.uint32)
    return tc, ib


def cmd_bake(args):
    from . import serialize as ser
    from .bake import bake
    from .stats import get_stats
    from .texture import Texture
    from .types import BakeInputDesc, Format, TextureFormat

    if args.input_blob:
        d = ser.deserialize(open(args.input_blob, "rb").read())
        if not d.input_descs:
            print("blob contains no input descs", file=sys.stderr)
            return 1
        desc = d.input_descs[0]
    else:
        plane = _load_alpha(args.texture, args.channel)
        tex = Texture([plane], TextureFormat.UNORM8,
                          alpha_cutoff=args.alpha_cutoff
                          if args.embed_cutoff else -1.0)
        if args.uvs:
            data = json.load(open(args.uvs))
            tc = np.array(data["texCoords"], np.float32)
            ib = np.array(data["indices"], np.uint32)
        else:
            tc, ib = _default_quad()
        desc = BakeInputDesc(
            texture=tex, tex_coords=tc, index_buffer=ib, index_count=len(ib),
            alpha_cutoff=args.alpha_cutoff,
            dynamic_subdivision_scale=args.dynamic_subdivision_scale,
            format=(Format.OC1_2_State if args.two_state
                    else Format.OC1_4_State),
            max_subdivision_level=args.subdivision_level)

    res = bake(desc, device=args.device)
    s = get_stats(res)
    print(json.dumps({
        "descCount": len(res.desc_array),
        "arrayDataSize": int(res.array_data.size),
        "indexFormat": res.index_format.name,
        "stats": s.__dict__,
    }, indent=2))
    if args.out:
        blob = ser.serialize(ser.DeserializedDesc(
            flags=(ser.SerializeFlags.COMPRESS if args.compress
                   else ser.SerializeFlags.NONE),
            result_descs=[res]))
        open(args.out, "wb").write(blob)
        print(f"wrote {len(blob)} bytes to {args.out}")
    return 0


def cmd_stats(args):
    from . import serialize as ser
    from .bake import bake
    from .stats import collect_stats, get_stats

    d = ser.deserialize(open(args.blob, "rb").read())
    out = []
    for i, res in enumerate(d.result_descs):
        s = collect_stats(res)
        out.append({"resultDesc": i, **s.__dict__})
    for i, desc in enumerate(d.input_descs):
        res = bake(desc, device=args.device)
        s = get_stats(res)
        out.append({"inputDescBaked": i, **s.__dict__})
    print(json.dumps(out, indent=2))
    return 0


def cmd_dump_images(args):
    from . import debug, serialize as ser
    from .bake import bake

    d = ser.deserialize(open(args.blob, "rb").read())
    if not d.input_descs:
        print("dump-images needs a blob with input descs", file=sys.stderr)
        return 1
    desc = d.input_descs[0]
    res = d.result_descs[0] if d.result_descs else \
        bake(desc, device=args.device)
    files = debug.save_as_images(desc, res, args.out_dir,
                                 file_postfix=args.postfix,
                                 one_file=not args.per_primitive,
                                 monochrome_unknowns=args.monochrome,
                                 scale=args.scale)
    print("\n".join(files))
    return 0


def cmd_info(args):
    from . import serialize as ser

    blob = open(args.blob, "rb").read()
    import struct
    stored, major, minor, patch, version, flags = struct.unpack_from(
        "<Qiiiii", blob, 0)
    info = {"size": len(blob), "digest": f"{stored:016x}",
            "sdkVersion": f"{major}.{minor}.{patch}",
            "descVersion": version, "flags": flags}
    d = ser.deserialize(blob)
    info["numInputDescs"] = len(d.input_descs)
    info["numResultDescs"] = len(d.result_descs)
    print(json.dumps(info, indent=2))
    return 0


def cmd_viewer(args):
    """Headless viewer loop: load blob, apply --set overrides, re-bake,
    write overlays / zooms / stats (tools/viewer analog)."""
    from .viewer import ViewerSession

    vs = ViewerSession(args.blob, device=args.device)
    for kv in args.set or []:
        k, _, v = kv.partition("=")
        vs.set_param(k, v)
    if args.reset:
        vs.reset_all()
    if args.tui:
        from .tui import run_curses
        run_curses(vs, auto_rebake=args.auto_rebake)
        return 0
    if args.frame:
        from .tui import TuiViewer, render_ansi
        tv = TuiViewer(vs)
        if args.zoom is not None:
            try:
                tv.zoom_to_prim(args.zoom)
            except IndexError as e:
                print(f"error: {e}", file=sys.stderr)
                return 2
        print(render_ansi(tv, rows=args.frame_rows, cols=args.frame_cols))
        return 0
    if args.params:
        for k, v in vs.params().items():
            print(f"{k} = {v}")
    if args.stats:
        print(vs.stats())
    if args.render:
        print(vs.save_png(args.render, scale=args.scale,
                          monochrome_unknowns=args.monochrome))
    if args.zoom is not None:
        from . import debug
        img = vs.zoom(args.zoom, scale=args.zoom_scale)
        out = args.zoom_out or f"zoom_prim{args.zoom}.png"
        debug._write_png(out, img)
        print(out)
    if args.reuse:
        groups = vs.reuse_groups()
        print(f"{len(groups)} distinct OMMs referenced by index")
        for desc_idx, prims in groups[:args.reuse_top]:
            mark = " (reused)" if len(prims) > 1 else ""
            print(f"  desc {desc_idx}: {len(prims)} primitive(s) "
                  f"{prims}{mark}")
    if args.inspect is not None:
        prim, _, rest = args.inspect.partition(":")
        kw = {}
        if "," in rest:
            u, _, v = rest.partition(",")
            kw["uv"] = (float(u), float(v))
        elif rest:
            kw["micro"] = int(rest)
        info = vs.inspect(int(prim), **kw)
        for k, v in info.items():
            print(f"{k} = {v}")
    if args.save:
        print(vs.save_blob(args.save))
    return 0


def cmd_bench(args):
    """Run ./bench.py in a child process and return its exit code.
    bench.py is the JAX package's benchmark: it imports jax (this process
    never does) and measures that package, not this one."""
    return subprocess.run([sys.executable, "bench.py"]).returncode


def main(argv=None):
    p = argparse.ArgumentParser(prog="omm_tpu_torch",
                                description="opacity micromap baker on a "
                                "CUDA card (the PyTorch port)")
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("bake", help="bake a texture or serialized input blob")
    b.add_argument("--texture", help="alpha texture PNG")
    b.add_argument("--channel", type=int, default=3)
    b.add_argument("--input-blob", help="serialized input blob (.bin)")
    b.add_argument("--uvs", help="JSON file with texCoords + indices")
    b.add_argument("--alpha-cutoff", type=float, default=0.5)
    b.add_argument("--embed-cutoff", action="store_true")
    b.add_argument("--subdivision-level", type=int, default=8)
    b.add_argument("--dynamic-subdivision-scale", type=float, default=0.0)
    b.add_argument("--two-state", action="store_true")
    b.add_argument("--device", default="cuda", choices=DEVICES)
    b.add_argument("--out", help="write serialized result blob")
    b.add_argument("--compress", action="store_true")
    b.set_defaults(fn=cmd_bake)

    s = sub.add_parser("stats", help="stats of a serialized blob")
    s.add_argument("blob")
    s.add_argument("--device", default="cuda", choices=DEVICES)
    s.set_defaults(fn=cmd_stats)

    di = sub.add_parser("dump-images", help="render state overlays to PNGs")
    di.add_argument("blob")
    di.add_argument("--out-dir", default="omm_images")
    di.add_argument("--postfix", default="omm")
    di.add_argument("--per-primitive", action="store_true")
    di.add_argument("--monochrome", action="store_true")
    di.add_argument("--scale", type=int, default=5)
    di.add_argument("--device", default="cuda", choices=DEVICES)
    di.set_defaults(fn=cmd_dump_images)

    i = sub.add_parser("info", help="inspect a serialized blob header")
    i.add_argument("blob")
    i.set_defaults(fn=cmd_info)

    v = sub.add_parser("viewer", help="headless viewer: load/tweak/re-bake/"
                       "render a serialized blob")
    v.add_argument("blob")
    v.add_argument("--set", action="append", metavar="PARAM=VALUE",
                   help="override a tweakable bake parameter")
    v.add_argument("--reset", action="store_true",
                   help="reset all parameters to the blob's values")
    v.add_argument("--params", action="store_true",
                   help="print the tweakable parameter values")
    v.add_argument("--stats", action="store_true")
    v.add_argument("--render", metavar="OUT.png")
    v.add_argument("--scale", type=int, default=5)
    v.add_argument("--monochrome", action="store_true")
    v.add_argument("--zoom", type=int, metavar="PRIM",
                   help="micro-triangle-level view of one primitive")
    v.add_argument("--zoom-scale", type=int, default=12)
    v.add_argument("--zoom-out", metavar="OUT.png")
    v.add_argument("--reuse", action="store_true",
                   help="browse OMM reuse: which primitives share descs")
    v.add_argument("--reuse-top", type=int, default=20)
    v.add_argument("--inspect", metavar="PRIM[:MICRO|:U,V]",
                   help="inspect one primitive, optionally one micro-"
                        "triangle by bird index or containing UV point")
    v.add_argument("--save", metavar="OUT.bin",
                   help="write the tweaked inputs + result as a new blob")
    v.add_argument("--device", default="cuda", choices=DEVICES)
    v.add_argument("--tui", action="store_true",
                   help="interactive terminal viewer (pan/zoom/inspect/"
                        "tweak/re-bake; curses)")
    v.add_argument("--auto-rebake", action="store_true",
                   help="TUI: re-bake immediately on parameter steps")
    v.add_argument("--frame", action="store_true",
                   help="print ONE ANSI half-block frame and exit "
                        "(honors --zoom PRIM)")
    v.add_argument("--frame-rows", type=int, default=24)
    v.add_argument("--frame-cols", type=int, default=80)
    v.set_defaults(fn=cmd_viewer)

    be = sub.add_parser("bench", help="run ./bench.py in a child process: "
                        "the JAX package's benchmark, which does not "
                        "measure this package")
    be.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
