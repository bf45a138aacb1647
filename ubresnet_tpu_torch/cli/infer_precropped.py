"""Precropped inference CLI (counterpart of
ubresnet_tpu/cli/infer_precropped.py).

    python -m ubresnet_tpu_torch.cli.infer_precropped \\
        -i in.uevt -o out.uevt -c ckpt.tar -b 16 [--device cuda]

Arg surface of the reference deploy/run_ubresnet_precropped.py:17-27
(-i -o -c -p -t [-b -n -v]). Checkpoints are reference-format .tar
files. Runs on the card unless ``--device cpu`` is given; prints the
timing dict as one JSON line.
"""
from __future__ import annotations

import argparse
import json

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
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.deploy import PrecroppedRunner
    from ubresnet_tpu_torch.deploy.weights import load_reference_checkpoint
    from ubresnet_tpu_torch.models import get_model
    from ubresnet_tpu_torch.utils.platform import resolve_device, strict_f32

    device = resolve_device(args.device)
    policy = Policy.f32() if args.f32 else Policy()
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
    timing = runner.run(args.input, args.output, plane=args.plane,
                        producer=args.producer, n_entries=args.nevents,
                        verbose=args.verbose)
    print(json.dumps(timing))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
