"""int8 accuracy ladder on briefly trained weights (counterpart of the
JAX package's tools/int8_ladder.py).

    python -m ubresnet_tpu_torch.tools.int8_ladder [train_steps] \\
        [--device cuda|cpu]

Trains the flagship UResNet for ``train_steps`` (default 30) Adam steps
on synthetic sparse-transfer batches so the activation distributions
are trained ones rather than init noise, then measures the ladder:

  1. PTQ abs-max          (ops/quant.calibrate, percentile None)
  2. PTQ percentile 99.9
  3. PTQ percentile 99.99
  4. QAT finetune         (Policy.quant_train, as many steps, from the
                           trained parameters — with fresh BN running
                           statistics and a fresh optimizer, as the JAX
                           tool replaces only the params), then PTQ
                           abs-max and percentile 99.9

Each rung is the port's ``Policy.int8()`` eval model (calibrated on the
eval batch) against the float32 eval model of the same weights: mean
|Δp| (``prob_mae_vs_f32``) and argmax agreement, so QAT's weight drift
does not pollute the quantization error; ``qat_f32_argmax_vs_pre_qat``
says whether QAT kept the float32 task behaviour. Prints one JSON line
with the JAX tool's keys; progress goes to stderr. Runs on the card
unless ``--device cpu``. ``UBTPU_BENCH_HW``, ``UBTPU_BENCH_INPLANES``
and ``UBTPU_BENCH_TRAIN_BATCH`` override the size, as for the JAX tool
(CPU smoke: ``UBTPU_BENCH_HW=64 UBTPU_BENCH_TRAIN_BATCH=2 ... 2
--device cpu``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np


def _env_int(name, default):
    return int(os.environ.get(name, default))


# the JAX package's bench.py sizes (bench.py:43-49), with its overrides
HW = _env_int("UBTPU_BENCH_HW", 512)
INPLANES = _env_int("UBTPU_BENCH_INPLANES", 16)
TRAIN_BATCH = _env_int("UBTPU_BENCH_TRAIN_BATCH", 32)
EVAL_CROPS = 8


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def make_train_batches(n=4, batch=None):
    """Sparse-transfer training batches of synthetic events, padded to
    one capacity per key (bench.py:190 make_train_batches)."""
    from ubresnet_tpu_torch.data.synthetic import synth_event
    from ubresnet_tpu_torch.ops.sparse import sparsify_batch

    rng = np.random.RandomState(1)
    batch = TRAIN_BATCH if batch is None else batch
    batches = []
    for _ in range(n):
        evs = [synth_event(rng, (HW, HW)) for _ in range(batch)]
        sp = sparsify_batch({
            "image": np.stack([e["wire"] for e in evs])[..., None],
            "label": np.stack([e["segment"] for e in evs]),
            "weight": np.stack([e["weight"] for e in evs])})
        sp.pop("hw")
        batches.append(sp)
    caps = {k: max(b[k].shape[1] for b in batches)
            for k in ("img_idx", "lab_idx", "wgt_idx")}
    for b in batches:
        for base in ("img", "lab", "wgt"):
            cap = caps[f"{base}_idx"]
            for suf in ("idx", "val"):
                arr = b[f"{base}_{suf}"]
                if arr.shape[1] < cap:
                    b[f"{base}_{suf}"] = np.pad(
                        arr, ((0, 0), (0, cap - arr.shape[1])))
    return batches


def run(steps: int = 30, device: str = "cuda") -> dict:
    import torch

    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.data.synthetic import synth_event
    from ubresnet_tpu_torch.deploy.weights import random_state_dict
    from ubresnet_tpu_torch.models import get_model
    from ubresnet_tpu_torch.ops.quant import calibrate
    from ubresnet_tpu_torch.train import (
        build_train_step,
        create_train_state,
        make_optimizer,
    )
    from ubresnet_tpu_torch.utils.platform import resolve_device, strict_f32

    dev = resolve_device(device)
    if dev.type == "cuda":
        strict_f32()  # the float32 references: no TF32
    batches = make_train_batches()
    log(f"data built: {len(batches)} train batches of "
        f"{TRAIN_BATCH}x{HW}x{HW}")
    init = random_state_dict(0, inplanes=INPLANES)

    def finetune(policy, sd, tag):
        model = get_model("uresnet", sd, policy=policy, device=dev,
                          train=True)
        opt = make_optimizer(model.parameters(), "adam", 1e-4,
                             weight_decay=1e-4)
        step = build_train_step(num_classes=3, sparse_hw=(HW, HW),
                                use_pallas_loss=policy.fused_train,
                                device=dev)
        state = create_train_state(model, opt)
        t0 = time.time()
        m = None
        for i in range(steps):
            state, m = step(state, batches[i % len(batches)])
            if i == 0:
                log(f"[{tag}] step0 {time.time() - t0:.1f}s "
                    f"loss {m['loss']:.4f}")
        log(f"[{tag}] {steps} steps in {time.time() - t0:.1f}s, "
            f"final loss {m['loss']:.4f}")
        return {k: v.detach().cpu() for k, v in model.state_dict().items()}

    # 1) brief training (bf16 compute, the default train policy)
    trained = finetune(Policy(), init, "train")

    rng = np.random.RandomState(99)
    xeval = np.stack([synth_event(rng, (HW, HW))["wire"]
                      for _ in range(EVAL_CROPS)])[..., None].astype(
                          np.float32)
    x = torch.from_numpy(xeval).to(dev)

    def f32_probs(sd):
        with torch.inference_mode():
            return get_model("uresnet", sd, policy=Policy.f32(),
                             device=dev)(x).exp().cpu().numpy()

    def ptq_rung(sd, percentile, ref):
        model = get_model("uresnet", sd, policy=Policy.int8(), device=dev)
        model.set_quant_scales(calibrate(model, [xeval],
                                         percentile=percentile))
        with torch.inference_mode():
            probs = model(x).exp().float().cpu().numpy()
        return {"prob_mae_vs_f32": round(float(np.abs(probs - ref).mean()),
                                         5),
                "argmax_agreement": round(float(
                    (probs.argmax(-1) == ref.argmax(-1)).mean()), 5)}

    ref = f32_probs(trained)
    results = {"train_steps": steps, "hw": HW, "inplanes": INPLANES}
    for tag, pct in (("absmax", None), ("p99.9", 99.9), ("p99.99", 99.99)):
        results[f"ptq_{tag}"] = ptq_rung(trained, pct, ref)
        log(f"ptq {tag}: {results[f'ptq_{tag}']}")

    # 4) QAT: the trained parameters, fresh BN running statistics
    start = {k: (init[k] if k.endswith(("running_mean", "running_var"))
                 else v) for k, v in trained.items()}
    qat_pol = dataclasses.replace(Policy(), quant_train=True,
                                  quant_percentile=0.0)
    qtrained = finetune(qat_pol, start, "qat")
    qref = f32_probs(qtrained)
    results["qat_absmax"] = ptq_rung(qtrained, None, qref)
    log(f"qat absmax: {results['qat_absmax']}")
    results["qat_p99.9"] = ptq_rung(qtrained, 99.9, qref)
    log(f"qat p99.9: {results['qat_p99.9']}")
    results["qat_f32_argmax_vs_pre_qat"] = round(
        float((qref.argmax(-1) == ref.argmax(-1)).mean()), 5)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="int8 PTQ/QAT accuracy ladder")
    ap.add_argument("train_steps", nargs="?", type=int, default=30)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    print(json.dumps(run(args.train_steps, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
