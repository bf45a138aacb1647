"""Training cells: the step ``Trainer`` builds, driven from the seed.

Set-up makes the weights and a pool of distinct batches from the seed,
sparsifies every batch once (the trainer's sparse transfer form,
ops/sparse.py:sparsify_batch), and builds one step object as
``Trainer._train_step`` builds it: the port's trainable model of the
configuration's ``arch`` under ``Policy()`` (the fused train zone and
the K7 loss), Adam at the configuration's settings,
``build_train_step`` with ``use_pallas_loss`` and ``sparse_hw``. The
first three steps, on three different batches, go through the same call
and feed as the window's; they are the comparison's readings (the
losses; after the first, each leaf's gradient as Adam got it, from its
first moment; after the third, each parameter's and running statistic's
change) and the warm-up. The same step object then runs the window: one
step after another over the pool,
each step's batch sent to the card and densified in the step, until
``seconds`` have passed. The rate counts every crop of every completed
step over the whole window.

After the window, with the program's state freed, the configuration's
reference takes three float32 steps from the same weights on the same
three batches (lib/check.py). ``control``: the reference in float8
e4m3 (the control of the comparison, portbench/tools/controls.py) is
compared in place of the program.
"""
from __future__ import annotations

import time

import numpy as np

CHECKED_STEPS = 3


def run(cell, seed: int, seconds: float, stretch, device, t_start: float,
        log, control: bool = False) -> dict:
    import torch

    from portbench.lib import common, synth
    from portbench.reference import weights
    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.models import get_model
    from ubresnet_tpu_torch.ops.sparse import sparsify_batch
    from ubresnet_tpu_torch.train.optimizers import make_optimizer
    from ubresnet_tpu_torch.train.step import (
        build_train_step,
        create_train_state,
    )

    cfg, tr = cell.config, cell.traffic
    opt_cfg = cfg["optimizer"]
    hw, B = tuple(tr["crop_hw"]), tr["batch"]
    marks = [("imports", time.perf_counter())]
    s_w, s_cal, s_pool = common.sub_seeds(seed, 3)
    cal = synth.crops(np.random.RandomState(s_cal), tr["calib_crops"], hw,
                      tr["generator"])["image"]
    sd0 = weights.make_state_dict(cfg, s_w, device,
                                  torch.from_numpy(cal).to(device))
    rng = np.random.RandomState(s_pool)
    dense, pool = [], []
    for i in range(tr["pool_batches"]):
        b = synth.crops(rng, B, hw, tr["generator"])
        b["label"] = b["label"].astype(np.int32)
        if i < CHECKED_STEPS:
            dense.append(b)
        sp = sparsify_batch(b, bucket=tr["sparse_bucket"])
        sp.pop("hw")
        pool.append(sp)
    marks.append(("weights and pool", time.perf_counter()))
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    policy = Policy()
    model = get_model(cfg["arch"], sd0, policy=policy, device=device,
                      train=True)
    marks.append(("model", time.perf_counter()))
    opt = make_optimizer(model.parameters(), opt_cfg["name"],
                         learning_rate=opt_cfg["lr"],
                         weight_decay=opt_cfg["weight_decay"])
    state = create_train_state(model, opt)
    step = build_train_step(num_classes=cfg["num_classes"],
                            use_pallas_loss=policy.fused_train,
                            sparse_hw=hw, device=device)

    marks.append(("optimizer and step", time.perf_counter()))
    names = dict(model.named_parameters())
    stats = dict(model.named_buffers())
    p0 = {k: p.detach().clone() for k, p in names.items()}
    b0 = {k: b.detach().clone() for k, b in stats.items()}
    losses = []
    grad1 = {}
    beta1 = opt.opt.param_groups[0]["betas"][0]
    for i in range(CHECKED_STEPS):
        state, m = step(state, pool[i])
        losses.append(m["loss"])
        if i == 0:  # the first moment after one step is (1 - beta1)·g
            grad1 = {k: float(opt.opt.state[p]["exp_avg"].norm())
                     / (1 - beta1) for k, p in names.items()
                     if p in opt.opt.state}
    update3 = {k: float((p.detach() - p0[k]).norm())
               for k, p in names.items()}
    bnstat3 = {k: float((b - b0[k]).norm()) for k, b in stats.items()}
    prog = {"losses": losses, "grad1": grad1, "update3": update3,
            "bnstat3": bnstat3}
    del p0, b0
    marks.append(("checked steps", time.perf_counter()))
    for i in range(tr["warmup_steps"]):
        state, m = step(state, pool[(CHECKED_STEPS + i) % len(pool)])
    marks.append(("warm-up", time.perf_counter()))
    stretch.start()
    setup_s = time.perf_counter() - t_start
    log(common.setup_line(t_start, marks))

    nan_before = state.nan_count
    k = CHECKED_STEPS + tr["warmup_steps"]
    started = []
    common.quiet_host()
    stretch.open()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        now = time.perf_counter()
        if now >= deadline:
            break
        started.append(now)
        with stretch.span("step"):
            state, m = step(state, pool[k % len(pool)])
        stretch.called()
        k += 1
    if device.type == "cuda":
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    window = t_end - t0
    stretch.finish()
    steps = len(started)
    skipped = state.nan_count - nan_before
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    log(f"window {window:.3f} s, {steps} steps of {B}, "
        f"losses {losses}, last {m['loss']}")

    del state, step, model, opt, names, stats, m
    if device.type == "cuda":
        torch.cuda.empty_cache()
    crops = steps * B

    def numbers():
        from portbench.lib import check

        feed = [{k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for k, v in b.items()} for b in dense]
        ref = common.reference_module(cfg)
        want = check.train_readings(ref, sd0, feed, opt_cfg["lr"],
                                    opt_cfg["weight_decay"])
        got = (check.train_readings(ref, sd0, feed, opt_cfg["lr"],
                                    opt_cfg["weight_decay"], quant=True)
               if control else prog)
        return check.train_numbers(got, want)

    return {
        "e2e": {"setup_s": setup_s,
                "train_crops_per_s": crops / window,
                "peak_mem_gib": peak / 2 ** 30},
        "attempted": crops, "failed": skipped * B, "peak_bytes": peak,
        "quiet": common.quiet_rate(sum(map(stretch.quiet, started)),
                                   stretch.quiet_from, t_end),
        "check": numbers,
    }
