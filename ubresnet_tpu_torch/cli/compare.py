"""Score-file parity CLI, tf/compare_caffe_to_tf.py's equivalent
(counterpart of ubresnet_tpu/cli/compare.py): per-class mean |Δscore|
over ADC>threshold pixels + label agreement, entries paired by
run/subrun/event.

    python -m ubresnet_tpu_torch.cli.compare a.uevt b.uevt \\
        --producer-a ssnet_plane2 --producer-b uburn_plane2 \\
        [--adc-file in.uevt] [--dump-dir DIR]
"""
from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser(description="Compare two score files")
    ap.add_argument("file_a")
    ap.add_argument("file_b")
    ap.add_argument("--producer-a", required=True)
    ap.add_argument("--producer-b", required=True)
    ap.add_argument("--adc-file", default=None)
    ap.add_argument("--adc-producer", default="wire")
    ap.add_argument("--adc-threshold", type=float, default=10.0)
    ap.add_argument("-n", "--nevents", type=int, default=None)
    ap.add_argument("--dump-dir", default=None,
                    help="write colormapped ADC/score/diff PNGs here")
    args = ap.parse_args(argv)

    from ubresnet_tpu_torch.parity import compare_score_files

    metrics = compare_score_files(
        args.file_a,
        args.file_b,
        args.producer_a,
        args.producer_b,
        adc_file=args.adc_file,
        adc_producer=args.adc_producer,
        adc_threshold=args.adc_threshold,
        n_entries=args.nevents,
        dump_dir=args.dump_dir,
    )
    print(json.dumps(metrics, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
