"""Readings that the limits of a cell's comparison are set from, on the
card at the cell's own size, in one process:

    python portbench/tools/controls.py --workload u16.score.b16 \
        --seeds 12 --control-seeds 3 --fault-seeds 3 --seconds 3

the program's sound runs (``--seeds`` seeds), the control (the program's
int8 path in scoring cells, the reference in float8 e4m3 in training
cells: kinds/*.py ``control``) and each planted fault of the cell's kind
(lib/faults.py). Each run is one line of JSON on standard output:
{workload, mode, seed, readings}. A short window at the cell's load is
enough: the comparison reads the first steps of training, and a sample
of the window's batches of scoring.
"""
import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first-seed", type=int, default=1000)
    args = ap.parse_args(argv)
    from portbench.lib import common, faults, harness

    common.pin_caches()
    cell = common.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("controls: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    kind = cell.traffic["kind"]
    plan = [("sound", i) for i in range(args.seeds)]
    plan += [("control", i) for i in range(args.control_seeds)]
    plan += [(f, i) for f in faults.FAULTS[kind]
             for i in range(args.fault_seeds)]
    for mode, i in plan:
        seed = args.first_seed + 7919 * i + 1
        readings = {}
        planted = (faults.planted(mode) if mode not in ("sound", "control")
                   else contextlib.nullcontext())
        with planted:
            harness.run_cell(cell, seed, args.seconds, False, device,
                             time.perf_counter(), control=mode == "control",
                             say=lambda m: None, readings=readings)
        print(json.dumps({"workload": args.workload, "mode": mode,
                          "seed": seed, "readings": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
