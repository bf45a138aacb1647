"""Golden-parity rig, one command, one report (counterpart of
ubresnet_tpu/cli/golden_parity.py).

The reference's acceptance discipline is parity against the official
2018-paper ssnet caffemodels ("all development will be benchmarked
against this model", reference caffe/README.md:9-13; per-plane weight
files named at caffe/run_caffe_precropped.py:26-30). This CLI runs the
three-leg pipeline and emits a single JSON report with per-plane label
agreement against a threshold (>= 0.999 on ADC>10 pixels by default).
Both legs run on the card unless ``--device cpu`` is given.

Modes:

* **Official weights** (when obtainable): the three per-plane
  caffemodels and the checkpoint under test, a reference .tar or, with
  ``--config``, a training checkpoint directory::

      python -m ubresnet_tpu_torch.cli.golden_parity -i test.uevt \\
          -w 0:plane0_iter_75500.caffemodel \\
          -w 1:plane1_iter_65500.caffemodel \\
          -w 2:plane2_iter_68000.caffemodel -c checkpoint.tar

  The caffe leg scores every plane through infer_caffe; the port's
  infer_precropped scores each plane with ``-p PLANE``; each plane's
  ``ssnet_plane%d`` and ``uburn_plane%d`` scores are compared.

* **Dry run** (no official weights needed)::

      python -m ubresnet_tpu_torch.cli.golden_parity --dry-run

  The same pipeline with surrogate "trained" weights at the oracle shape
  (512x512): (1) a synthetic 3-plane event file, (2) per-plane surrogate
  caffemodels (real NetParameter binaries through write_caffemodel; the
  same bytes as the JAX package's), (3) the caffe oracle leg, (4) a
  second, independent parse and run of the same weights, (5) the
  per-plane comparison against the threshold, and (6) a NEGATIVE
  control: plane-2 weights perturbed by a 20% multiplicative gaussian
  must push label agreement BELOW the threshold, proving the comparator
  can fail. Exit status is 0 only if every positive leg clears the
  threshold and the negative control is detected.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np


def make_three_plane_file(path: str, n_events: int, hw, seed: int = 0) -> str:
    """Synthetic UEVT file with one wire image per plane (0, 1, 2) per
    event, the precropped deploy layout (reference
    deploy/run_ubresnet_precropped.py scores one plane per pass)."""
    from ubresnet_tpu_torch.data.meta import Image2D, ImageMeta
    from ubresnet_tpu_torch.data.synthetic import synth_event
    from ubresnet_tpu_torch.data.uevt import EventFileWriter

    rng = np.random.RandomState(seed)
    with EventFileWriter(path) as out:
        for i in range(n_events):
            out.set_id(1, 0, i)
            for plane in (0, 1, 2):
                ev = synth_event(rng, hw)
                meta = ImageMeta(
                    0.0, 0.0, float(hw[1]), float(hw[0]), hw[0], hw[1], plane
                )
                out.append("wire", Image2D(ev["wire"], meta, 1, 0, i))
            out.save_entry()
    return path


def make_surrogate_weights(outdir: str, seed_base: int = 100) -> dict:
    """Per-plane surrogate caffemodels: the generated ssnet2018 graph's
    msra/bilinear-filled parameters serialized as real NetParameter
    binaries, stand-ins with the exact layer names and shapes the
    official files carry. Weights are drawn on the host (numpy)."""
    from ubresnet_tpu_torch.models.ssnet2018 import ssnet2018_prototxt
    from ubresnet_tpu_torch.parity.caffe import CaffeNet, write_caffemodel

    prototxt = ssnet2018_prototxt()
    paths = {}
    for plane in (0, 1, 2):
        params = CaffeNet(prototxt, seed=seed_base + plane,
                          device="cpu").params
        rng = np.random.RandomState(seed_base + plane)
        # a raw msra-filled 200-layer net on O(100)-ADC inputs
        # saturates its head (exact 1/0 softmax rows, or all-clamped
        # ReLU logits), useless for exercising the comparator. Tame
        # the head like a trained net: small score-conv weights, small
        # nonzero biases so every class carries signal.
        for name in ("conv10", "conv11"):
            if name in params:
                blobs = params[name]
                blobs[0] = (blobs[0] * 0.05).astype(np.float32)
                if len(blobs) > 1:
                    blobs[1] = rng.uniform(
                        -0.1, 0.1, blobs[1].shape
                    ).astype(np.float32)
        p = os.path.join(outdir, f"surrogate_plane{plane}.caffemodel")
        write_caffemodel(p, params)
        paths[plane] = p
    return paths


def run_caffe_leg(input_file, output_file, weights_by_plane, n_entries=None,
                  device="cuda"):
    from ubresnet_tpu_torch.cli.infer_caffe import main as caffe_main

    argv = ["-i", input_file, "-o", output_file, "--device", device]
    for plane, path in weights_by_plane.items():
        argv += ["-w", f"{plane}:{path}"]
    if n_entries:
        argv += ["-n", str(n_entries)]
    caffe_main(argv)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Golden parity vs the ssnet2018 caffe oracle"
    )
    ap.add_argument("-i", "--input", default=None,
                    help="event UEVT file (dry run synthesizes one)")
    ap.add_argument("-w", "--weights", action="append", default=None,
                    metavar="PLANE:FILE", help="official per-plane caffemodel")
    ap.add_argument("-c", "--checkpoint", default=None,
                    help="checkpoint under test: a reference .tar, or a "
                         "training checkpoint directory with --config")
    ap.add_argument("--config", default=None,
                    help="TrainConfig of a checkpoint directory")
    ap.add_argument("--threshold", type=float, default=0.999,
                    help="label-agreement acceptance bar (ADC>10 pixels)")
    ap.add_argument("--adc-threshold", type=float, default=10.0)
    ap.add_argument("--dry-run", action="store_true",
                    help="surrogate-weight pipeline exercise (no official "
                    "weights needed)")
    ap.add_argument("--hw", type=int, default=512,
                    help="dry-run image size (default: the 512x512 oracle "
                    "shape)")
    ap.add_argument("-n", "--nevents", type=int, default=2)
    ap.add_argument("-o", "--report", default=None,
                    help="write the JSON report here (default: stdout only)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where both legs run (default: the card)")
    args = ap.parse_args(argv)

    from ubresnet_tpu_torch.parity.compare import compare_score_files

    report = {"mode": "dry-run" if args.dry_run else "official",
              "threshold": args.threshold, "planes": {}}
    tmp = tempfile.mkdtemp(prefix="golden_parity_")
    ok = True

    if args.dry_run:
        input_file = args.input or make_three_plane_file(
            os.path.join(tmp, "events.uevt"), args.nevents,
            (args.hw, args.hw),
        )
        weights = make_surrogate_weights(tmp)
        report["surrogate_weights"] = {str(k): v for k, v in weights.items()}

        # leg 1: caffe oracle scores
        oracle_out = os.path.join(tmp, "oracle.uevt")
        run_caffe_leg(input_file, oracle_out, weights, args.nevents,
                      args.device)
        # leg 2: independent reload of the same weights (fresh parse +
        # fresh CaffeNet), standing in for the converted model
        reload_out = os.path.join(tmp, "reload.uevt")
        run_caffe_leg(input_file, reload_out, weights, args.nevents,
                      args.device)

        for plane in (0, 1, 2):
            m = compare_score_files(
                oracle_out, reload_out,
                f"ssnet_plane{plane}", f"ssnet_plane{plane}",
                adc_file=input_file, adc_threshold=args.adc_threshold,
            )
            m["passes"] = m["label_agreement"] >= args.threshold
            ok &= m["passes"]
            report["planes"][str(plane)] = m

        # negative control: perturbed plane-2 weights must be DETECTED
        from ubresnet_tpu_torch.parity.caffe import (
            parse_caffemodel,
            write_caffemodel,
        )

        perturbed = parse_caffemodel(weights[2])
        rng = np.random.RandomState(7)
        for name, blobs in perturbed.items():
            blobs[0] = blobs[0] * (
                1.0 + 0.2 * rng.randn(*blobs[0].shape).astype(np.float32)
            )
        pw_path = os.path.join(tmp, "perturbed_plane2.caffemodel")
        write_caffemodel(pw_path, perturbed)
        neg_out = os.path.join(tmp, "negative.uevt")
        run_caffe_leg(input_file, neg_out, {2: pw_path}, args.nevents,
                      args.device)
        mneg = compare_score_files(
            oracle_out, neg_out, "ssnet_plane2", "ssnet_plane2",
            adc_file=input_file, adc_threshold=args.adc_threshold,
        )
        mneg["detected"] = mneg["label_agreement"] < args.threshold
        ok &= mneg["detected"]
        report["negative_control"] = mneg
    else:
        if not args.weights or not args.checkpoint or not args.input:
            ap.error("official mode needs -i, -w (x3), and -c; or use "
                     "--dry-run")
        weights = {}
        for spec in args.weights:
            plane, _, path = spec.partition(":")
            weights[int(plane)] = path
        oracle_out = os.path.join(tmp, "oracle.uevt")
        run_caffe_leg(args.input, oracle_out, weights, args.nevents,
                      args.device)

        from ubresnet_tpu_torch.cli.infer_precropped import main as infer_main

        ours_out = os.path.join(tmp, "ours.uevt")
        for plane in sorted(weights):
            argv2 = ["-i", args.input, "-o", ours_out, "-c",
                     args.checkpoint, "-p", str(plane), "--device",
                     args.device]
            if args.config:
                argv2 += ["--config", args.config]
            if args.nevents:
                argv2 += ["-n", str(args.nevents)]
            infer_main(argv2)
            m = compare_score_files(
                oracle_out, ours_out,
                f"ssnet_plane{plane}", f"uburn_plane{plane}",
                adc_file=args.input, adc_threshold=args.adc_threshold,
            )
            m["passes"] = m["label_agreement"] >= args.threshold
            ok &= m["passes"]
            report["planes"][str(plane)] = m

    report["ok"] = ok
    text = json.dumps(report, indent=2)
    print(text)
    if args.report:
        with open(args.report, "w") as f:
            f.write(text + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
