"""Precropped inference CLI (counterpart of
ubresnet_tpu/cli/infer_precropped.py).

    python -m ubresnet_tpu_torch.cli.infer_precropped \\
        -i in.uevt -o out.uevt -c ckpt.tar -b 16 [--device cuda] \\
        [--int8 [--int8-calib N] [--int8-percentile P]]

Arg surface of the reference deploy/run_ubresnet_precropped.py:17-27
(-i -o -c -p -t [-b -n -v]). Checkpoints are reference-format .tar
files. Runs on the card unless ``--device cpu`` is given; prints the
timing dict as one JSON line (with ``--int8`` also the calibration's
seconds, ``calibrate``).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def build_parser():
    ap = argparse.ArgumentParser(description="Score precropped event images")
    ap.add_argument("-i", "--input", required=True, help="input .uevt file")
    ap.add_argument("-o", "--output", required=True, help="output .uevt file")
    ap.add_argument("-c", "--checkpoint", required=True,
                    help="reference-format .tar checkpoint")
    ap.add_argument("-p", "--plane", type=int, default=2, help="wire plane id")
    ap.add_argument("-t", "--producer", default="wire", help="ADC image producer")
    ap.add_argument("-b", "--batchsize", type=int, default=8)
    ap.add_argument("-n", "--nevents", type=int, default=None)
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--f32", action="store_true",
                    help="full-f32 parity mode (no kernel zone, TF32 off)")
    ap.add_argument("--f16-scores", action="store_true",
                    help="store score images as float16 (~5e-4 quantisation)")
    ap.add_argument("--compact-readback", nargs="?", const="f16",
                    default=False, choices=["f16", "u8"],
                    help="ship K-1 class scores off the device in f16 (the "
                         "default when the flag is bare) or u8 fixed point; "
                         "the host rebuilds the last class")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs (default cuda; cpu only "
                         "when asked for)")
    ap.add_argument("--int8", action="store_true",
                    help="int8 PTQ inference (ops/quant.py): calibrate "
                         "activation scales on the first --int8-calib "
                         "input images, then run the int8 zone (stem, "
                         "enc1, dec2, dec1, head) s8xs8->s32 on the "
                         "K1-s8/K2-s8/K3-s8 kernels")
    ap.add_argument("--int8-calib", type=int, default=32, metavar="N",
                    help="calibration images taken from the input "
                         "(default 32)")
    ap.add_argument("--int8-percentile", type=float, default=None,
                    metavar="P",
                    help="calibrate scales from the P-th percentile of "
                         "nonzero |x| instead of abs-max (e.g. 99.9; "
                         "outlier-robust, saturates the largest "
                         "activations)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.deploy import PrecroppedRunner
    from ubresnet_tpu_torch.deploy.weights import load_reference_checkpoint
    from ubresnet_tpu_torch.models import get_model
    from ubresnet_tpu_torch.utils.platform import resolve_device, strict_f32

    if args.int8 and args.f32:
        raise SystemExit("--int8 and --f32 are mutually exclusive")
    device = resolve_device(args.device)
    policy = (Policy.f32() if args.f32 else
              Policy.int8() if args.int8 else Policy())
    if args.f32:
        strict_f32()
    if not args.checkpoint.endswith(".tar"):
        raise SystemExit("the port reads reference-format .tar checkpoints")
    sd, _ = load_reference_checkpoint(args.checkpoint)
    model = get_model("uresnet", sd, policy=policy, device=device)
    runner = PrecroppedRunner(
        model,
        batch_size=args.batchsize,
        compact_readback=args.compact_readback,
        score_dtype=np.float16 if args.f16_scores else np.float32,
    )
    calib_s = None
    if args.int8:
        t0 = time.time()
        n_cal = runner.calibrate_from(
            args.input, plane=args.plane, producer=args.producer,
            n_images=args.int8_calib, percentile=args.int8_percentile)
        calib_s = time.time() - t0
        if args.verbose:
            print(f"int8: calibrated on {n_cal} images")
    timing = runner.run(args.input, args.output, plane=args.plane,
                        producer=args.producer, n_entries=args.nevents,
                        verbose=args.verbose)
    if calib_s is not None:
        timing["calibrate"] = calib_s
    print(json.dumps(timing))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
