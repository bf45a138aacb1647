"""Training CLI (counterpart of ubresnet_tpu/cli/train.py).

    python -m ubresnet_tpu_torch.cli.train --config cfg.json \\
        [--set optim.lr=1e-4 ...] [--device cuda|cpu]

A JSON or PSet config (core/config.py, the JAX package's keys) plus
``--set a.b=c`` overrides. Runs on the card unless ``--device cpu``;
prints the run summary as JSON and returns 1 when the run failed.
``--trace`` and ``--debug-dump`` are not in the port yet and raise.
"""
from __future__ import annotations

import argparse
import json

from ubresnet_tpu_torch.core.config import TrainConfig


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
    ap = argparse.ArgumentParser(description="Train a UResNet on the card")
    ap.add_argument("--config", "-c", required=True,
                    help="JSON or PSet config file")
    ap.add_argument("--set", action="append", dest="overrides",
                    metavar="KEY=VALUE", help="override config entries "
                                              "(dot paths)")
    ap.add_argument("--dump-config", action="store_true",
                    help="print the resolved config and exit")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where training runs (default cuda; cpu only when "
                         "asked for)")
    ap.add_argument("--debug-dump", default=None, metavar="DIR",
                    help="not in the port yet")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="not in the port yet")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = apply_overrides(TrainConfig.load(args.config), args.overrides)
    if args.dump_config:
        print(cfg.to_json())
        return 0
    if args.debug_dump or args.trace:
        raise NotImplementedError("--debug-dump and --trace are not in the "
                                  "port yet")
    from ubresnet_tpu_torch.train.trainer import Trainer

    summary = Trainer(cfg, device=args.device).run()
    print(json.dumps({k: v for k, v in summary.items() if k != "error"},
                     indent=2))
    return 1 if "error" in summary else 0


if __name__ == "__main__":
    raise SystemExit(main())
