"""Caffe-graph inference CLI, run_caffe_precropped.py's equivalent
(counterpart of ubresnet_tpu/cli/infer_caffe.py).

    python -m ubresnet_tpu_torch.cli.infer_caffe -i in.uevt -o out.uevt \\
        -w 0:plane0.caffemodel -w 1:plane1.caffemodel \\
        -w 2:plane2.caffemodel [--prototxt net.prototxt] [--device cuda]

Runs the 2018-paper caffe network (official .caffemodel weights per
plane, caffe/run_caffe_precropped.py:26-30) through parity/caffe.py's
CaffeNet in float32 with TF32 off, one net per plane on the device (a
plane without ``-w`` gets the graph's seed-0 fillers, as in the JAX
package), and writes per-class float32 score images to
``ssnet_plane%d`` under the input's run/subrun/event ids, with the
reference's per-stage timing report as one JSON line. Runs on the card
unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import time
from collections import OrderedDict

import numpy as np


def build_parser():
    ap = argparse.ArgumentParser(description="Run a caffe graph on event images")
    ap.add_argument("-i", "--input", required=True,
                    help="input event file (.uevt or larcv .root)")
    ap.add_argument("-o", "--output", required=True, help="output UEVT file")
    ap.add_argument(
        "--prototxt",
        default=None,
        help="model prototxt (default: built-in ssnet2018 generator)",
    )
    ap.add_argument(
        "-w",
        "--weights",
        action="append",
        default=None,
        metavar="PLANE:FILE",
        help="per-plane caffemodel, e.g. 0:plane0.caffemodel (repeatable)",
    )
    ap.add_argument("-t", "--producer", default="wire")
    ap.add_argument("-n", "--nevents", type=int, default=None)
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the card (default) or, when asked, the CPU")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    from ubresnet_tpu_torch.data.meta import Image2D
    from ubresnet_tpu_torch.data.rootio import open_event_file
    from ubresnet_tpu_torch.data.uevt import EventFileWriter
    from ubresnet_tpu_torch.models.ssnet2018 import ssnet2018_prototxt
    from ubresnet_tpu_torch.parity.caffe import CaffeNet, parse_caffemodel
    from ubresnet_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    prototxt = args.prototxt or ssnet2018_prototxt()
    weights_by_plane = {}
    for spec in args.weights or []:
        plane, _, path = spec.partition(":")
        weights_by_plane[int(plane)] = parse_caffemodel(path)

    nets = {}

    def net_for(plane):
        if plane not in nets:
            w = weights_by_plane.get(plane)
            nets[plane] = CaffeNet(prototxt, weights=w, device=device)
        return nets[plane]

    timing = OrderedDict(
        [("total", 0.0), ("read", 0.0), ("forward", 0.0), ("write", 0.0)]
    )
    t_total = time.time()
    reader = open_event_file(args.input)
    writer = EventFileWriter(args.output)
    n = len(reader) if args.nevents is None else min(args.nevents, len(reader))
    for i in range(n):
        t0 = time.time()
        ev = reader.read_entry(i, producers=[args.producer])
        timing["read"] += time.time() - t0
        for img in ev[args.producer]:
            plane = img.meta.plane
            net = net_for(plane)
            t0 = time.time()
            x = torch.from_numpy(
                np.ascontiguousarray(img.pixels, np.float32))[None, ..., None]
            with torch.inference_mode():
                scores = net(x.to(device))["softmax"][0].cpu().numpy()
            timing["forward"] += time.time() - t0
            t0 = time.time()
            for c in range(scores.shape[-1]):
                writer.append(
                    f"ssnet_plane{plane}",
                    Image2D(scores[..., c].astype(np.float32), img.meta, *img.rse),
                )
            timing["write"] += time.time() - t0
        writer.set_id(*reader.rse(i))
        writer.save_entry()
        if args.verbose:
            print(f"entry {i} done", flush=True)
    writer.close()
    timing["total"] = time.time() - t_total
    if args.verbose:
        print("------ timing -------")
        for k, v in timing.items():
            print(f"{k} : {v:.3f} s / {v / max(n, 1):.5f} s per event")
    print(json.dumps(timing))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
