"""Run one cell of the port's benchmark once, on the machine it starts on.

    python portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The workload is a cell of BENCHMARK.json;
its files are found by name (portbench/lib/common.py). The run makes its
weights and inputs from ``--seed``, sets up and warms up (``setup_s``:
from this process's start to the window), measures for ``--seconds``,
then compares what the timed path produced with the plain float32
reference. ``--trace 1`` profiles a bounded stretch of the window and
reports the cell's per-layer metrics instead of its end-to-end ones.

The last line on standard output is the result, one JSON object; the
numbers compared, each beside its limit, are the last lines on standard
error and the result's last key. Without a CUDA card, or with fewer
than the cell asks for, the run prints no result and exits 2; if JAX or
the JAX package was loaded into this process, 3.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# one thread in the CPU pools of numpy's and torch's libraries, set before
# either loads: the host paces the cells, and a pool of threads on cores
# that other tenants share can stall it
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench.lib import common

    common.pin_caches()
    cell = common.load_cell(args.workload)
    import torch

    import ubresnet_tpu_torch  # noqa: F401  the system under test

    torch.set_num_threads(1)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s), found {n}; no result", file=sys.stderr)
        return 2
    from portbench.lib import harness

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), device, T_START)
    if args.trace:
        result["device"]["power_limit"] = common.power_limit()
        harness.log(f"card {result['device']['power_limit']}")
    bad = common.forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package were loaded: "
              f"{', '.join(bad)}; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
