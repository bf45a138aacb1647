"""Whole-view inference CLI (counterpart of
ubresnet_tpu/cli/infer_wholeview.py; the reference's
deploy/run_ubresnet_wholeview.py): score whole-plane images.

    python -m ubresnet_tpu_torch.cli.infer_wholeview \\
        -i planes.uevt -o scores.uevt -c ckpt.tar [--device cuda] \\
        [--planes 0 1 2] [--stitched | --detsplit] [--passthrough] \\
        [--int8 [--int8-calib N] [--int8-percentile P]] [--f16-scores]

By default each whole plane is scored in one forward (padded to a
multiple of 32 rows and columns, batch 1); ``--stitched`` scores
overlapping 512x832 crops ``--crop-batch`` at a time and
overlap-averages them, and ``--detsplit`` places those crops as
3D-consistent triplets across the U/V/Y planes (crop semantics, so it
implies ``--stitched``). Scores go to producer ``ubsnet_plane%d`` with
the input's meta and ids. Checkpoints are reference-format .tar files.
Runs on the card unless ``--device cpu`` is given; prints the timing
dict (total / read / splitscore / write, and ``calibrate`` with
``--int8``) as one JSON line.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def resolve_spatial(spatial, stitched, detsplit) -> bool:
    """Whether to score whole planes in one forward.

    Spatial is the default, as in the JAX package; on an NVIDIA H100
    80GB HBM3 at its 700 W limit it is also the faster path (7.07
    against 8.45 ms of forward a 1008x3456 plane, chip_smoke.py's
    wholeview phase, PERF.md).
    ``--stitched`` opts out, ``--detsplit`` implies crops (the
    UBSplitDetector triplet geometry exists only in crop space), and an
    explicit ``--spatial`` with ``--detsplit`` is a contradiction."""
    if spatial and detsplit:
        raise SystemExit("--spatial and --detsplit are mutually "
                         "exclusive (detsplit defines crop triplets)")
    if spatial is None:
        return not stitched and not detsplit
    return spatial and not stitched


def build_parser():
    ap = argparse.ArgumentParser(description="Score whole-plane event images")
    ap.add_argument("-i", "--input", required=True, help="input .uevt file")
    ap.add_argument("-o", "--output", required=True, help="output .uevt file")
    ap.add_argument("-c", "--checkpoint", required=True,
                    help="reference-format .tar checkpoint")
    ap.add_argument("-t", "--producer", default="wire")
    ap.add_argument("-n", "--nevents", type=int, default=None)
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--planes", type=int, nargs="*", default=None)
    ap.add_argument("--tile-rows", type=int, default=512)
    ap.add_argument("--tile-cols", type=int, default=832)
    ap.add_argument("--overlap-rows", type=int, default=16)
    ap.add_argument("--overlap-cols", type=int, default=176)
    ap.add_argument("--crop-batch", type=int, default=10)
    ap.add_argument("--config", default=None,
                    help="orbax checkpoints: not ported (exits)")
    ap.add_argument("--arch", default="uresnet",
                    choices=["uresnet", "aspp_resnet"],
                    help="aspp_resnet is not ported (exits)")
    ap.add_argument("--best", action="store_true",
                    help="orbax checkpoints: not ported (exits)")
    ap.add_argument("--f32", action="store_true",
                    help="full-f32 parity mode (no kernel zone, TF32 off)")
    ap.add_argument("--f16-scores", action="store_true",
                    help="store score images as float16 (~5e-4 quantisation)")
    ap.add_argument("--detsplit", action="store_true",
                    help="3D-consistent crop triplets across U/V/Y "
                         "(UBSplitDetector semantics) instead of "
                         "independent per-plane grids")
    ap.add_argument("--passthrough", action="store_true",
                    help="copy input event content to the output file "
                         "(IOManager kBOTH mode)")
    ap.add_argument("--spatial", action="store_true", default=None,
                    help="score each whole plane in one forward (the "
                         "default; implied off by --detsplit)")
    ap.add_argument("--stitched", action="store_true",
                    help="score overlapping crops and stitch them")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs (default cuda; cpu only "
                         "when asked for)")
    ap.add_argument("--int8", action="store_true",
                    help="int8 PTQ inference (ops/quant.py): calibrate "
                         "activation scales on occupied tiles of the "
                         "first --int8-calib input planes, then run the "
                         "int8 zone on the K1-s8/K2-s8/K3-s8 kernels")
    ap.add_argument("--int8-calib", type=int, default=4, metavar="N",
                    help="whole-plane images used for calibration "
                         "(default 4; every occupied tile of each)")
    ap.add_argument("--int8-percentile", type=float, default=None,
                    metavar="P",
                    help="calibrate scales from the P-th percentile of "
                         "nonzero |x| instead of abs-max (e.g. 99.9)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ubresnet_tpu_torch.cli.common import load_model
    from ubresnet_tpu_torch.deploy import WholeViewRunner

    use_spatial = resolve_spatial(args.spatial, args.stitched, args.detsplit)
    model = load_model(args)
    runner = WholeViewRunner(
        model,
        tile_rows=args.tile_rows,
        tile_cols=args.tile_cols,
        min_overlap_rows=args.overlap_rows,
        min_overlap_cols=args.overlap_cols,
        crop_batch=args.crop_batch,
        spatial=use_spatial,
        score_dtype=np.float16 if args.f16_scores else np.float32,
    )
    calib_s = None
    if args.int8:
        t0 = time.time()
        n_cal = runner.calibrate_from(
            args.input, producer=args.producer, planes=args.planes,
            n_images=args.int8_calib, percentile=args.int8_percentile)
        calib_s = time.time() - t0
        if args.verbose:
            print(f"int8: calibrated on {n_cal} tiles")
    timing = runner.run(
        args.input,
        args.output,
        producer=args.producer,
        planes=args.planes,
        n_entries=args.nevents,
        detsplit=args.detsplit,
        passthrough=args.passthrough,
        verbose=args.verbose,
    )
    if calib_s is not None:
        timing["calibrate"] = calib_s
    print(json.dumps(timing))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
