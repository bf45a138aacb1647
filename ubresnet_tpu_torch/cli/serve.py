"""Watch-dir serving mode (counterpart of ubresnet_tpu/cli/serve.py):
score event files as they arrive, with one warm model across files —
the production wrapper around the precropped and wholeview runners.

    python -m ubresnet_tpu_torch.cli.serve --watch-dir in/ --out-dir out/ \\
        -c model.tar [-p 2] [--device cuda]
    ... --once            # drain the backlog and exit
    ... --wholeview       # whole-plane split/score/stitch
    ... --root-out        # write larcv .root outputs

Inputs are .uevt or larcv .root files (sniffed by magic). A file counts
as processed when its output (``<name>_scores.uevt``, or
``<name>_scores.root`` with ``--root-out``: float32 scores under the
runners' producers) exists; a ``<name>.failed`` marker quarantines a file that raised (its
partial output removed), so one bad file cannot wedge the loop. A new
file is served only after its size held across two polls (a writer may
be mid-copy). Prints one JSON line per served file, and
``{"shutdown": true, "served": N}`` when SIGTERM, SIGINT or ``--once``
ends the loop. ``--wholeview`` scores crops and stitches them, as the
JAX package's serve loop does.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--watch-dir", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("-c", "--checkpoint", required=True,
                    help="reference-format .tar checkpoint, or a "
                         "training checkpoint directory (--config)")
    ap.add_argument("--config",
                    help="TrainConfig of a checkpoint directory -c DIR: "
                         "its model section")
    ap.add_argument("--best", action="store_true",
                    help="a checkpoint directory's best.tar, not its "
                         "newest step")
    ap.add_argument("--arch", default="uresnet",
                    choices=["uresnet", "aspp_resnet"],
                    help="model architecture (default uresnet; a .tar "
                         "holding ASPP keys runs as aspp_resnet either "
                         "way)")
    ap.add_argument("-p", "--plane", type=int, default=2)
    ap.add_argument("-t", "--producer", default="wire")
    ap.add_argument("-b", "--batchsize", type=int, default=8)
    ap.add_argument("--wholeview", action="store_true",
                    help="serve whole-plane images (split/score/stitch, "
                         "deploy/wholeview.py) instead of precropped; "
                         "-p is ignored, use --planes")
    ap.add_argument("--planes", type=int, nargs="*", default=None,
                    help="wholeview: planes to score (default all)")
    ap.add_argument("--tile-rows", type=int, default=512)
    ap.add_argument("--tile-cols", type=int, default=832)
    ap.add_argument("--overlap-rows", type=int, default=16)
    ap.add_argument("--overlap-cols", type=int, default=176)
    ap.add_argument("--crop-batch", type=int, default=10)
    ap.add_argument("--poll", type=float, default=2.0,
                    help="seconds between directory scans")
    ap.add_argument("--once", action="store_true",
                    help="process the current backlog, then exit")
    ap.add_argument("--root-out", action="store_true",
                    help="write .root (larcv write-back) outputs")
    ap.add_argument("--f16-scores", action="store_true",
                    help="store score images as float16 (half the bytes)")
    ap.add_argument("--f32", action="store_true",
                    help="full-f32 parity mode (no kernel zone, TF32 off)")
    ap.add_argument("--int8", action="store_true",
                    help="int8 PTQ inference; activation scales are "
                         "calibrated on the first served file "
                         "(ops/quant.py)")
    ap.add_argument("--int8-calib", type=int, default=32, metavar="N",
                    help="calibration images from the first file "
                         "(default 32; with --wholeview: whole planes, "
                         "every occupied tile of each)")
    ap.add_argument("--int8-percentile", type=float, default=None,
                    metavar="P",
                    help="calibrate scales from the P-th percentile of "
                         "nonzero |x| instead of abs-max (e.g. 99.9)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs (default cuda; cpu only "
                         "when asked for)")
    ap.add_argument("-v", "--verbose", action="store_true")
    return ap


def _candidates(watch_dir):
    for name in sorted(os.listdir(watch_dir)):
        if name.endswith((".uevt", ".root")):
            yield name


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import numpy as np

    from ubresnet_tpu_torch.cli.common import load_model
    from ubresnet_tpu_torch.deploy import PrecroppedRunner, WholeViewRunner

    model = load_model(args)
    os.makedirs(args.out_dir, exist_ok=True)
    score_dtype = np.float16 if args.f16_scores else np.float32
    if args.wholeview:
        runner = WholeViewRunner(
            model, score_dtype=score_dtype,
            tile_rows=args.tile_rows, tile_cols=args.tile_cols,
            min_overlap_rows=args.overlap_rows,
            min_overlap_cols=args.overlap_cols,
            crop_batch=args.crop_batch,
        )
    else:
        runner = PrecroppedRunner(model, batch_size=args.batchsize,
                                  score_dtype=score_dtype)

    stop = {"flag": False}

    def _sig(*_):
        stop["flag"] = True

    saved = {s: signal.signal(s, _sig) for s in (signal.SIGTERM,
                                                  signal.SIGINT)}
    try:
        served = _serve(args, runner, stop)
    finally:  # an in-process caller gets its own handlers back
        for s, handler in saved.items():
            signal.signal(s, handler)
    print(json.dumps({"shutdown": True, "served": served}), flush=True)
    return 0


def _serve(args, runner, stop) -> int:
    """The watch loop until ``stop["flag"]`` or, with ``--once``, the
    end of the backlog; returns the number of files served."""
    ext = ".root" if args.root_out else ".uevt"
    sizes = {}
    served = 0
    calibrated = False
    while not stop["flag"]:
        backlog = []
        for name in _candidates(args.watch_dir):
            base = os.path.splitext(name)[0]
            out = os.path.join(args.out_dir, base + "_scores" + ext)
            failed = os.path.join(args.out_dir, name + ".failed")
            if os.path.exists(out) or os.path.exists(failed):
                continue
            path = os.path.join(args.watch_dir, name)
            size = os.path.getsize(path)
            # two consecutive stable-size polls before serving: one
            # stable pair can be a writer descheduled mid-copy
            last, stable = sizes.get(name, (None, 0))
            stable = stable + 1 if size == last else 0
            sizes[name] = (size, stable)
            if not args.once and stable < 2:
                continue
            backlog.append((name, path, out, failed))
        for name, path, out, failed in backlog:
            if stop["flag"]:
                break
            try:
                t0 = time.time()
                if args.int8 and not calibrated:
                    if args.wholeview:
                        n_cal = runner.calibrate_from(
                            path, producer=args.producer,
                            planes=args.planes, n_images=args.int8_calib,
                            percentile=args.int8_percentile)
                        unit = "tiles"
                    else:
                        n_cal = runner.calibrate_from(
                            path, plane=args.plane, producer=args.producer,
                            n_images=args.int8_calib,
                            percentile=args.int8_percentile)
                        unit = "images"
                    calibrated = True
                    if args.verbose:
                        print(f"int8: calibrated on {n_cal} {unit} "
                              f"from {name}", flush=True)
                if args.wholeview:
                    timing = runner.run(path, out, producer=args.producer,
                                        planes=args.planes,
                                        verbose=args.verbose)
                else:
                    timing = runner.run(path, out, plane=args.plane,
                                        producer=args.producer,
                                        verbose=args.verbose)
                served += 1
                print(json.dumps({
                    "served": name, "output": os.path.basename(out),
                    "seconds": round(time.time() - t0, 3),
                    "timing": {k: round(v, 3) for k, v in timing.items()},
                }), flush=True)
            except Exception as exc:  # quarantine, keep serving
                if os.path.exists(out):
                    os.remove(out)
                with open(failed, "w") as f:
                    f.write(f"{type(exc).__name__}: {exc}\n")
                print(json.dumps({"failed": name, "error": str(exc)}),
                      file=sys.stderr, flush=True)
        if args.once:
            break
        time.sleep(args.poll)
    return served


if __name__ == "__main__":
    sys.exit(main())
