"""Training CLI (counterpart of ubresnet_tpu/cli/train.py).

    python -m ubresnet_tpu_torch.cli.train --config cfg.json \\
        [--set optim.lr=1e-4 ...] [--device cuda|cpu] \\
        [--trace DIR] [--debug-dump DIR]

A JSON or PSet config (core/config.py, the JAX package's keys) plus
``--set a.b=c`` overrides (``--set model.name=aspp_resnet`` trains an
ASPP-ResNet, ``--set model.remat=true`` recomputes each stage in
backward, ``--set remat=true`` the whole forward). Runs on the
card unless ``--device cpu`` (or ``UBTPU_PLATFORM=cpu``, the JAX
package's switch, which the launcher's children inherit); prints the
run summary as JSON and returns 1 when the run failed. Started by
``cli/launch.py --distributed N`` (the UBTPU_* env contract), it first
joins the process group (parallel/distributed.py) and prints
``distributed: process i/n, backend …, device …``. ``--trace DIR`` writes a torch.profiler
Chrome trace of the run to ``DIR/trace.json``; ``--debug-dump DIR``
writes the first batch's adc_i / label_i / weight_i PNGs and exits.
"""
from __future__ import annotations

import argparse
import json
import os

from ubresnet_tpu_torch.core.config import TrainConfig
from ubresnet_tpu_torch.utils.platform import (
    PLATFORM_ENV,
    default_device_name,
)


def apply_overrides(cfg: TrainConfig, overrides):
    for ov in overrides or []:
        key, _, raw = ov.partition("=")
        if not raw:
            raise SystemExit(f"--set expects key=value, got '{ov}'")
        try:
            val = json.loads(raw)
        except json.JSONDecodeError:
            val = raw
        obj = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            if not hasattr(obj, p):
                raise SystemExit(f"unknown config section '{p}'")
            obj = getattr(obj, p)
            if obj is None:
                raise SystemExit(f"config section '{p}' is unset")
        if not hasattr(obj, parts[-1]):
            raise SystemExit(f"unknown config key '{key}'")
        setattr(obj, parts[-1], val)
    return cfg


def build_parser():
    ap = argparse.ArgumentParser(
        description="Train a UResNet or an ASPP-ResNet on the card")
    ap.add_argument("--config", "-c", required=True,
                    help="JSON or PSet config file")
    ap.add_argument("--set", action="append", dest="overrides",
                    metavar="KEY=VALUE", help="override config entries "
                                              "(dot paths)")
    ap.add_argument("--dump-config", action="store_true",
                    help="print the resolved config and exit")
    ap.add_argument("--device", default=default_device_name(),
                    choices=["cuda", "cpu"],
                    help="where training runs (default cuda; cpu only when "
                         "asked for, or with UBTPU_PLATFORM=cpu)")
    ap.add_argument("--debug-dump", default=None, metavar="DIR",
                    help="dump one batch as ADC/label/weight PNGs and exit "
                         "(the reference's debug fixture, "
                         "train_ubresnet2018_wlarcv2.py:188-207)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="wrap training in a torch.profiler trace written "
                         "to DIR/trace.json (Chrome trace; the "
                         "reference's RUNPROFILER block, "
                         "train_ubresnet2018_wlarcv2.py:51,209)")
    return ap


def debug_dump(cfg: TrainConfig, out_dir: str) -> int:
    """The first training batch as adc_i / label_i / weight_i heat-map
    PNGs in ``out_dir``; returns the number of samples."""
    from ubresnet_tpu_torch.train.trainer import make_loader
    from ubresnet_tpu_torch.utils.png import save_heatmap

    os.makedirs(out_dir, exist_ok=True)
    loader = make_loader(cfg.train_data, seed=cfg.seed).start()
    try:
        batch = loader[0]
    finally:
        loader.stop()
    n = batch["image"].shape[0]
    for i in range(n):
        save_heatmap(os.path.join(out_dir, f"adc_{i}.png"),
                     batch["image"][i, ..., 0])
        save_heatmap(os.path.join(out_dir, f"label_{i}.png"),
                     batch["label"][i], 0, cfg.model.num_classes - 1)
        save_heatmap(os.path.join(out_dir, f"weight_{i}.png"),
                     batch["weight"][i])
    return n


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = apply_overrides(TrainConfig.load(args.config), args.overrides)
    if args.dump_config:
        print(cfg.to_json())
        return 0
    if args.debug_dump:
        n = debug_dump(cfg, args.debug_dump)
        print(f"dumped {n} samples to {args.debug_dump}")
        return 0
    from ubresnet_tpu_torch.parallel import distributed
    from ubresnet_tpu_torch.train.trainer import Trainer
    from ubresnet_tpu_torch.utils.platform import resolve_device

    # one training across processes when the launcher set the UBTPU_*
    # env contract (a no-op otherwise); every run names its device, and
    # the switch when it put the run on the CPU
    if distributed.initialize(device=args.device):
        print(f"distributed: process {distributed.process_index()}/"
              f"{distributed.process_count()}, backend "
              f"{distributed.backend()}, device "
              f"{resolve_device(args.device)}", flush=True)
    else:
        via = (f" ({PLATFORM_ENV}=cpu)" if args.device == "cpu"
               and default_device_name() == "cpu" else "")
        print(f"device: {resolve_device(args.device)}{via}", flush=True)
    trainer = Trainer(cfg, device=args.device)
    if args.trace:
        from ubresnet_tpu_torch.utils.profiling import trace

        with trace(args.trace):
            summary = trainer.run()
    else:
        summary = trainer.run()
    print(json.dumps({k: v for k, v in summary.items() if k != "error"},
                     indent=2))
    if "error" in summary:
        return 1  # leave the group to the exit: peers may be gone
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
