"""Data conversion CLI (counterpart of ubresnet_tpu/cli/convert.py) —
bring reference (larcv/ROOT) data into UEVT, and UEVT back to larcv.

Preferred path — direct, no ROOT installation needed:

    python -m ubresnet_tpu_torch.cli.convert events.root events.uevt
    python -m ubresnet_tpu_torch.cli.convert --inspect events.root
    python -m ubresnet_tpu_torch.cli.convert --to-root scores.uevt out.root

The native reader (the port's cpp/rootio.cpp via data/rootio.py)
walks the ROOT container format itself and decodes larcv EventImage2D
branches stored object-wise, member-wise (kStreamedMemberWise), or in
split trees (per-member leaf branches). A layout outside those is
reported with a diagnostic; for such files, fall back to the
PyROOT-side NPZ export below (one loop, on the reference side where
larcv is already installed):

    # reference-side export (PyROOT + larcv), writes NPZ per entry set
    io = larcv.IOManager(larcv.IOManager.kREAD)
    io.add_in_file("events.root"); io.initialize()
    out = {}
    for i in range(io.get_n_entries()):
        io.read_entry(i)
        for producer in ("wire", "segment", "ts_keyspweight"):
            ev = io.get_data(larcv.kProductImage2D, producer)
            for img in ev.Image2DArray():
                m = img.meta()
                out[f"{i}/{producer}/{m.plane()}"] = larcv.as_ndarray(img)
                out[f"{i}/{producer}/{m.plane()}/meta"] = np.array(
                    [m.min_x(), m.min_y(), m.max_x(), m.max_y(),
                     m.rows(), m.cols(), m.plane()])
        out[f"{i}/rse"] = np.array([io.event_id().run(),
                                    io.event_id().subrun(),
                                    io.event_id().event()])
    np.savez_compressed("events.npz", **out)

then convert here:  python -m ubresnet_tpu_torch.cli.convert events.npz events.uevt
"""
from __future__ import annotations

import argparse
from collections import defaultdict

import numpy as np


def npz_to_uevt(npz_path: str, out_path: str, verbose: bool = False) -> int:
    from ubresnet_tpu_torch.data.meta import Image2D, ImageMeta
    from ubresnet_tpu_torch.data.uevt import EventFileWriter

    data = np.load(npz_path)
    entries = defaultdict(dict)
    metas = {}
    rses = {}
    for key in data.files:
        parts = key.split("/")
        if parts[-1] == "rse":
            rses[int(parts[0])] = data[key]
        elif parts[-1] == "meta":
            metas["/".join(parts[:-1])] = data[key]
        else:
            entries[int(parts[0])][key] = data[key]

    n = 0
    with EventFileWriter(out_path) as w:
        for entry in sorted(entries):
            rse = rses.get(entry, np.array([0, 0, entry]))
            w.set_id(int(rse[0]), int(rse[1]), int(rse[2]))
            for key, pixels in sorted(entries[entry].items()):
                _, producer, plane = key.split("/")
                m = metas.get(key)
                if m is not None:
                    meta = ImageMeta(
                        float(m[0]), float(m[1]), float(m[2]), float(m[3]),
                        int(m[4]), int(m[5]), int(m[6]),
                    )
                else:
                    rows, cols = pixels.shape
                    meta = ImageMeta(0.0, 0.0, float(cols), float(rows),
                                     rows, cols, int(plane))
                w.append(
                    producer,
                    Image2D(np.ascontiguousarray(pixels), meta,
                            int(rse[0]), int(rse[1]), int(rse[2])),
                )
            w.save_entry()
            n += 1
            if verbose and n % 100 == 0:
                print(f"{n} entries", flush=True)
    return n


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Convert reference data (larcv .root directly via the "
        "native reader, or NPZ exports) to UEVT"
    )
    ap.add_argument("input", help=".root (native reader), .npz "
                    "(see module docstring for the export layout), or "
                    ".uevt (with --to-root)")
    ap.add_argument("output", nargs="?", help="output UEVT file "
                    "(or .root with --to-root)")
    ap.add_argument(
        "--to-root",
        action="store_true",
        help="convert UEVT back to a larcv-compatible .root file (the "
        "write-back path: results flow to reference-ecosystem consumers)",
    )
    ap.add_argument(
        "--producers",
        help="comma-separated larcv producers to convert (.root only; "
        "default: every image2d tree found)",
    )
    ap.add_argument(
        "--inspect",
        action="store_true",
        help="print the ROOT file's keys/branches/decode status and exit",
    )
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    if args.inspect:
        from ubresnet_tpu_torch.data.rootio import inspect_file

        print(inspect_file(args.input))
        return 0
    if not args.output:
        ap.error("output is required unless --inspect")
    if args.to_root:
        from ubresnet_tpu_torch.data.rootio import uevt_to_root

        producers = args.producers.split(",") if args.producers else None
        n = uevt_to_root(args.input, args.output, producers, args.verbose)
    elif args.input.endswith(".root"):
        from ubresnet_tpu_torch.data.rootio import root_to_uevt

        producers = args.producers.split(",") if args.producers else None
        n = root_to_uevt(args.input, args.output, producers, args.verbose)
    else:
        n = npz_to_uevt(args.input, args.output, args.verbose)
    print(f"wrote {n} entries to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
