"""Train-step A/B matrix on the card, with an optional torch.profiler
trace (counterpart of the JAX package's tools/profile_train.py, its
entry point for the deconv-AD configuration).

    python -m ubresnet_tpu_torch.tools.profile_train          # A/B matrix
    python -m ubresnet_tpu_torch.tools.profile_train trace    # + a trace

For batches 16 and 32 at 512², three configurations of the bf16 train
step (Adam, lr 1e-4, weight decay 1e-4; the loss kernel K7 wherever the
train zone is on, as the trainer runs it): ``plain`` (every layer a
torch op under autograd), ``train zone`` (Policy.fused_train) and
``train zone + deconv AD`` (and Policy.fused_train_deconv). Each takes
2 warm steps on one fixed batch, then ``STEPS`` steps timed with CUDA
events; one line per row gives ms/step and crops/s. ``trace`` then
records 3 steps of the train zone at batch 16 with torch.profiler into
``build/profile_train/trace.json`` under the checkout and prints its
20 largest device kernels. Needs a card.
"""
from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

HW = 512
STEPS = 8
BATCHES = (16, 32)
# (tag, Policy overrides): the JAX tool's matrix — its default XLA path,
# fused_train, fused_train + fused_train_deconv
CONFIGS = (("plain", {"fused_train": False}),
           ("train zone", {"fused_train": True}),
           ("train zone + deconv AD", {"fused_train": True,
                                       "fused_train_deconv": True}))
TRACE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "profile_train")


def make_batch(rng, b):
    """ADC-like occupancy 10%, uniform labels, unit weights."""
    adc = (rng.rand(b, HW, HW, 1) > 0.9) * rng.rand(b, HW, HW, 1) * 50
    return {"image": adc.astype(np.float32),
            "label": rng.randint(0, 3, (b, HW, HW)).astype(np.int32),
            "weight": np.ones((b, HW, HW), np.float32)}


def drive(b, n, tag, rng, **overrides):
    """Build the model and step for one configuration, take 2 warm and
    ``n`` timed steps; returns (ms per step, state, step, batch)."""
    import torch

    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.deploy.weights import random_state_dict
    from ubresnet_tpu_torch.models import get_model
    from ubresnet_tpu_torch.train import (
        build_train_step,
        create_train_state,
        make_optimizer,
    )
    from ubresnet_tpu_torch.train.step import to_device

    dev = torch.device("cuda")
    pol = dataclasses.replace(Policy(), **overrides)
    model = get_model("uresnet", random_state_dict(0), policy=pol,
                      device=dev, train=True)
    opt = make_optimizer(model.parameters(), "adam", 1e-4, weight_decay=1e-4)
    step = build_train_step(num_classes=3, use_pallas_loss=pol.fused_train,
                            device=dev)
    state = create_train_state(model, opt)
    batch = to_device(make_batch(rng, b), dev)
    for _ in range(2):
        state, _ = step(state, batch)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        state, _ = step(state, batch)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / n
    print(f"{tag:24s} b{b}: {ms:8.1f} ms/step  {b / ms * 1e3:7.1f} crops/s",
          flush=True)
    return ms, state, step, batch


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    mode = argv[0] if argv else "ab"
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device; it measures the card",
              file=sys.stderr)
        return 1
    print("device:", torch.cuda.get_device_name(0), flush=True)
    rng = np.random.RandomState(0)
    for b in BATCHES:
        for tag, overrides in CONFIGS:
            drive(b, STEPS, tag, rng, **overrides)
            torch.cuda.empty_cache()
    if mode == "trace":
        from torch.profiler import ProfilerActivity, profile

        _, state, step, batch = drive(16, 2, "trace target", rng,
                                      fused_train=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                state, _ = step(state, batch)
            torch.cuda.synchronize()
        os.makedirs(TRACE_DIR, exist_ok=True)
        path = os.path.join(TRACE_DIR, "trace.json")
        prof.export_chrome_trace(path)

        def device_ms(e):  # per step
            us = getattr(e, "self_device_time_total", None)
            return (e.self_cuda_time_total if us is None else us) / 3e3

        for e in sorted(prof.key_averages(), key=device_ms,
                        reverse=True)[:20]:
            print(f"{device_ms(e):9.3f} ms/step  {e.count // 3:5d}x  "
                  f"{e.key[:90]}", flush=True)
        print(f"trace written to {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
