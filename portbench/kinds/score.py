"""Scoring cells: the precropped runner's pipeline without file I/O.

Set-up makes the weights and a pool of distinct crops from the seed,
builds the port's eval model of the configuration's ``arch`` and
``PrecroppedRunner`` as the CLI does (sparse COO transfer, full float32
scores back), fixes the sparse capacity as the runner's pre-scan does,
and warms up on the pool. The window is the runner's closed loop, one
batch in flight: dispatch batch k (sparsify, pad, enqueue forward and
readback), then drain batch k-1
(``_fetch``: wait for its scores on the host), cycling through the pool
until ``seconds`` have passed, then drain the last. A batch's latency
runs from its dispatch call to its scores on the host; the rate counts
every crop whose scores reached the host, over the whole window.

A sample of the window's batches, drawn from the seed as they complete
(a reservoir), keeps its scores; after the window, with the program's
state freed, the configuration's reference scores the same crops
(lib/check.py).

``control``: the program's own int8 path (``Policy.int8()``, its scales
calibrated on the pool's first batch, as ``--int8`` calibrates on the
input's first crops) in place of its bf16 path: the comparison's
control, run by portbench/tools/controls.py, never by a benchmark run.
"""
from __future__ import annotations

import time

import numpy as np


def run(cell, seed: int, seconds: float, stretch, device, t_start: float,
        log, control: bool = False) -> dict:
    import torch

    from portbench.lib import common, synth
    from portbench.reference import weights
    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.deploy.precropped import (
        SPARSE_BUCKET,
        PrecroppedRunner,
    )
    from ubresnet_tpu_torch.models import get_model
    from ubresnet_tpu_torch.ops.sparse import round_capacity

    cfg, tr = cell.config, cell.traffic
    hw, B = tuple(tr["crop_hw"]), tr["batch"]
    marks = [("imports", time.perf_counter())]
    s_w, s_cal, s_pool, s_sample = common.sub_seeds(seed, 4)
    cal = synth.crops(np.random.RandomState(s_cal), tr["calib_crops"], hw,
                      tr["generator"])["image"]
    sd = weights.make_state_dict(cfg, s_w, device,
                                 torch.from_numpy(cal).to(device))
    pool = synth.crops(np.random.RandomState(s_pool), tr["pool_crops"], hw,
                       tr["generator"])["image"].astype(np.float32)
    batches = [pool[i:i + B] for i in range(0, len(pool), B)]
    marks.append(("weights and pool", time.perf_counter()))
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    policy = Policy.int8() if control else Policy()
    model = get_model(cfg["arch"], sd, policy=policy, device=device)
    if control:
        from ubresnet_tpu_torch.ops.quant import calibrate

        model.set_quant_scales(calibrate(model, [batches[0]]))
    runner = PrecroppedRunner(model, batch_size=B)
    # the runner's pre-scan: one sparse capacity for the whole stream
    runner._cap = round_capacity(int((pool != 0).sum((1, 2, 3)).max()),
                                 SPARSE_BUCKET)
    marks.append(("program", time.perf_counter()))
    for i in range(tr["warmup_batches"]):
        runner._fetch(runner._dispatch(batches[i % len(batches)]), B, hw)
    marks.append(("warm-up", time.perf_counter()))
    stretch.start()
    setup_s = time.perf_counter() - t_start
    log(common.setup_line(t_start, marks))

    rng = np.random.RandomState(s_sample)
    keep = tr["check_batches"]
    sample = []           # (pool batch index, scores), a reservoir
    sent, latency, dispatch_s = [], [], []   # by batch, in order
    done = 0
    common.quiet_host()
    stretch.open()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    last = None
    k = 0
    while True:
        now = time.perf_counter()
        if now >= deadline:
            break
        bi = k % len(batches)
        with stretch.span("dispatch"):
            pending = runner._dispatch(batches[bi])
        sent.append(now)
        dispatch_s.append(time.perf_counter() - now)
        stretch.called()
        if last is not None:
            with stretch.span("fetch"):
                scores = runner._fetch(last[2], B, hw)
            latency.append(time.perf_counter() - last[1])
            done = _keep(sample, keep, rng, done, (last[0], scores))
        last = (bi, now, pending)
        k += 1
    if last is not None:
        scores = runner._fetch(last[2], B, hw)
        latency.append(time.perf_counter() - last[1])
        done = _keep(sample, keep, rng, done, (last[0], scores))
    t_end = time.perf_counter()
    window = t_end - t0
    stretch.finish()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    log(f"window {window:.3f} s, {len(latency)} batches of {B}")

    del runner, model, pending, last
    if device.type == "cuda":
        torch.cuda.empty_cache()
    crops = len(latency) * B
    # the host-clock readings of batches sent with no profile running
    # (all of them unless traced)
    quiet = [i for i, t in enumerate(sent) if stretch.quiet(t)]
    return {
        "e2e": {"setup_s": setup_s,
                "score_crops_per_s": crops / window,
                "peak_mem_gib": peak / 2 ** 30},
        "attempted": crops, "failed": 0, "peak_bytes": peak,
        "dispatch_s": [dispatch_s[i] for i in quiet],
        "latency_s": [latency[i] for i in quiet],
        "quiet": common.quiet_rate(len(quiet), stretch.quiet_from, t_end),
        "check": lambda: _numbers(cfg, sd, batches, sample, device),
    }


def _keep(sample, keep, rng, seen, item):
    """Reservoir sampling of ``keep`` items; returns the count seen."""
    if len(sample) < keep:
        sample.append(item)
    else:
        j = rng.randint(0, seen + 1)
        if j < keep:
            sample[j] = item
    return seen + 1


def _numbers(cfg, sd, batches, sample, device):
    from portbench.lib import check, common

    pairs = [(batches[bi], scores) for bi, scores in sample]
    return check.score_numbers(common.reference_module(cfg), sd, pairs,
                               device)
