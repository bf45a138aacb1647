"""Accuracy-evaluation CLI, ana/dllee_ssnet_comparison.py +
caffe/analyze_accuracy.py capability (counterpart of
ubresnet_tpu/cli/evaluate.py).

    python -m ubresnet_tpu_torch.cli.evaluate scores.uevt truth.uevt \\
        --score-producer uburn_plane2 [--plane 2] [--ignore-label L]
"""
from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Evaluate score images against truth labels"
    )
    ap.add_argument("score_file")
    ap.add_argument("truth_file")
    ap.add_argument("--score-producer", required=True)
    ap.add_argument("--truth-producer", default="segment")
    ap.add_argument("--adc-producer", default="wire")
    ap.add_argument("--adc-threshold", type=float, default=10.0)
    ap.add_argument("--no-adc-mask", action="store_true",
                    help="score every pixel, not just charge-bearing ones")
    ap.add_argument("--ignore-label", type=int, default=None,
                    help="truth label to exclude (ambiguous pixels)")
    ap.add_argument("--plane", type=int, default=None)
    ap.add_argument("-n", "--nevents", type=int, default=None)
    args = ap.parse_args(argv)

    from ubresnet_tpu_torch.parity.evaluate import evaluate_files

    metrics = evaluate_files(
        args.score_file,
        args.truth_file,
        score_producer=args.score_producer,
        truth_producer=args.truth_producer,
        adc_producer=None if args.no_adc_mask else args.adc_producer,
        adc_threshold=args.adc_threshold,
        ignore_label=args.ignore_label,
        plane=args.plane,
        n_entries=args.nevents,
    )
    print(json.dumps(metrics, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
