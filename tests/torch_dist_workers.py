"""Rank programs for the port's multi-process tests
(tests/test_torch_distributed.py) and for chip_smoke.py's distributed
phase, run in spawned processes by ``run_spawned``. They import only
torch and the port (no jax), so each rank starts quickly; each writes
what it computed to ``<out>/rank<r>.pt``."""
import os
import socket
import time
from typing import Callable, Sequence

import numpy as np
import torch

HW, INPLANES, DEPTH, LR = 32, 8, 2, 1e-2


def free_port(host: str = "127.0.0.1") -> int:
    """A TCP port nothing listens on now."""
    with socket.socket() as sock:
        sock.bind((host, 0))
        return sock.getsockname()[1]


def _spawned(rank: int, fn: Callable, world: int, coordinator: str,
             args: Sequence):
    from ubresnet_tpu_torch.parallel import distributed

    os.environ.update({distributed.COORDINATOR_ENV: coordinator,
                       distributed.NUM_PROCESSES_ENV: str(world),
                       distributed.PROCESS_ID_ENV: str(rank)})
    fn(rank, *args)


def run_spawned(fn: Callable, world: int, args: Sequence = (),
                timeout_s: float = 600.0) -> None:
    """Run ``fn(rank, *args)`` in ``world`` fresh processes (start
    method spawn: a forked child must never touch CUDA), each with the
    env contract of one world on a free localhost port; ``fn`` calls
    ``initialize`` itself. Raises if a process fails or the world has
    not finished within ``timeout_s`` (then every process is killed)."""
    import torch.multiprocessing as mp

    coord = f"127.0.0.1:{free_port()}"
    ctx = mp.start_processes(_spawned, args=(fn, world, coord, tuple(args)),
                             nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.time() + timeout_s
    try:
        while not ctx.join(timeout=max(0.0, min(1.0,
                                                deadline - time.time()))):
            if time.time() >= deadline:
                raise TimeoutError(f"spawned world of {world} did not "
                                   f"finish within {timeout_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def global_batch(seed=2, b=4, hw=HW):
    """A sparse ADC-like batch: hits with class labels 1-2 and larger
    weights on a 0.4 background, as tests/test_torch_train.py's."""
    rng = np.random.RandomState(seed)
    img = np.zeros((b, hw, hw, 1), np.float32)
    lab = np.zeros((b, hw, hw), np.int32)
    wgt = np.full((b, hw, hw), 0.4, np.float32)
    for i in range(b):
        n = 80
        ys, xs = rng.randint(0, hw, n), rng.randint(0, hw, n)
        img[i, ys, xs, 0] = rng.rand(n) * 50 + 5
        lab[i, ys, xs] = rng.randint(1, 3, n)
        wgt[i, ys, xs] = rng.rand(n) * 5 + 1
    return {"image": img, "label": lab, "weight": wgt}


def state_dict():
    from ubresnet_tpu_torch.deploy.weights import random_state_dict

    return random_state_dict(seed=0, inplanes=INPLANES, depth=DEPTH)


def sgd_step(sd, batch, accum_steps=1, mesh=None, policy=None):
    """One SGD step (lr 1e-2, momentum 0.9, weight decay 1e-3) of the
    port's train step on ``batch``: (metrics, state_dict, grads)."""
    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.models import get_model
    from ubresnet_tpu_torch.parallel.sharding import shard_state
    from ubresnet_tpu_torch.train import optimizers
    from ubresnet_tpu_torch.train.step import (
        build_train_step,
        create_train_state,
    )

    model = get_model("uresnet", sd, policy=policy or Policy.f32(),
                      device="cpu", train=True)
    opt = optimizers.make_optimizer(model.parameters(), "sgd", LR,
                                    weight_decay=1e-3, momentum=0.9)
    state = create_train_state(model, opt)
    if mesh is not None:
        state = shard_state(state, mesh)
    step = build_train_step(num_classes=3, accum_steps=accum_steps,
                            device="cpu", mesh=mesh)
    state, metrics = step(state, batch)
    grads = {k: p.grad.detach().clone()
             for k, p in model.named_parameters()}
    sd_out = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return metrics, sd_out, grads


def bn_zone(x, r, mesh=None):
    """A train-zone conv (K5's form: y with Σy, Σy²) and its train-mode
    BatchNorm on ``x``, loss Σ relu(bn(y))·r: (y, running stats, the
    parameter gradients, dx)."""
    import dataclasses

    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.deploy.weights import random_state_dict
    from ubresnet_tpu_torch.models.blocks import BatchNorm, Conv, conv_bn

    sd = random_state_dict(seed=1)
    pol = dataclasses.replace(Policy.f32(), fused_train=True)
    conv = Conv(sd, "enc_layer1.res1.conv1", policy=pol, device="cpu")
    bn = BatchNorm(sd, "enc_layer1.res1.bn1", policy=pol, device="cpu")
    assert conv.zone
    bn.train()
    bn.data_group = None if mesh is None else mesh.group
    x = x.clone().requires_grad_(True)
    y = conv_bn(conv, bn, x, act=True)
    (y * r).sum().backward()
    return {"y": y.detach(), "mean": bn.running_mean.clone(),
            "var": bn.running_var.clone(), "dx": x.grad,
            "w": conv.weight.grad, "gamma": bn.weight.grad,
            "beta": bn.bias.grad}


def bn_inputs():
    g = torch.Generator().manual_seed(3)
    return (torch.rand(4, 16, 16, 16, generator=g),
            torch.randn(4, 16, 16, 32, generator=g))


def train_world(rank, out):
    """Rank ``rank`` of a 2-rank gloo world: the train steps (plain,
    accum 2, a NaN in rank 1's shard), the guard's decision, the zone
    BatchNorm, then the trainer's checkpoints and resume."""
    from ubresnet_tpu_torch.core.mesh import make_mesh
    from ubresnet_tpu_torch.parallel import distributed
    from ubresnet_tpu_torch.parallel.sharding import all_true, shard_batch

    import sys

    # TensorBoard is optional (train/logging.py) and importing it pulls
    # in TensorFlow where that is installed (~10 s); the JSONL log is
    # what the test reads
    sys.modules.setdefault("torch.utils.tensorboard", None)
    torch.set_num_threads(1)
    res = {"joined": distributed.initialize(device="cpu")}
    res["rank"], res["world"] = (distributed.process_index(),
                                 distributed.process_count())
    res["backend"] = distributed.backend()
    mesh = make_mesh()
    sd = state_dict()
    batch = global_batch()
    for name, accum in (("plain", 1), ("accum2", 2)):
        res[name] = sgd_step(sd, shard_batch(batch, mesh, accum), accum,
                             mesh)
    poisoned = shard_batch(batch, mesh)
    if rank == 1:
        poisoned["image"][0, 5, 5, 0] = np.nan
    res["nan"] = sgd_step(sd, poisoned, 1, mesh)
    res["guard"] = (all_true(rank != 1, mesh.group),
                    all_true(True, mesh.group))
    x, r = bn_inputs()
    res["bn_zone"] = bn_zone(x[2 * rank:2 * rank + 2],
                             r[2 * rank:2 * rank + 2], mesh)
    res["trainer"] = trainer_runs(rank, out)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    distributed.shutdown()


def trainer_runs(rank, out):
    """The trainer on a tiny config: 2 iterations with a checkpoint each
    (recording which rank writes), then a resumed run to 3."""
    import json

    from ubresnet_tpu_torch.core.config import TrainConfig
    from ubresnet_tpu_torch.train import trainer as trainer_mod

    cfg_path = os.path.join(out, "cfg.json")
    writes = []
    save = trainer_mod.save_checkpoint

    def recording(*a, **kw):
        writes.append(rank)
        return save(*a, **kw)

    trainer_mod.save_checkpoint = recording
    runs = []
    for extra in ({"num_iters": 2}, {"num_iters": 3, "resume": True}):
        cfg = json.load(open(cfg_path))
        cfg.update(extra)
        t = trainer_mod.Trainer(TrainConfig.from_dict(cfg), device="cpu")
        summary = t.run()
        runs.append({"summary": summary,
                     "params": {k: v.detach().clone() for k, v in
                                t.model.state_dict().items()}})
    return {"runs": runs, "writes": writes}


# the model axis at JAX's geometry (tests/test_sharding.py:
# test_model_axis_sharding_matches): inplanes 8, depth 5, 32x32, global
# batch 4, min_features 32, Policy.f32, SGD lr 1e-3 without momentum
MA_INPLANES, MA_MIN, MA_LR = 8, 32, 1e-3


def ma_state_dict():
    from ubresnet_tpu_torch.deploy.weights import random_state_dict

    return random_state_dict(seed=0, inplanes=MA_INPLANES)


def ma_step(sd, batch, opt_name, mesh=None):
    """One step of ``opt_name`` (sgd: no momentum, JAX's test; adam) on
    ``batch``, with the model axis of ``mesh``: the metrics, the whole
    state_dict and optimizer state after it (gathered over the model
    group), the optimizer moments this rank holds, the sharded keys and
    the bytes of parameters plus moments."""
    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.models import get_model
    from ubresnet_tpu_torch.parallel.sharding import (
        make_param_shardings,
        param_state_bytes,
        shard_state,
        whole_optimizer_state,
        whole_state_dict,
    )
    from ubresnet_tpu_torch.train import optimizers
    from ubresnet_tpu_torch.train.step import (
        build_train_step,
        create_train_state,
    )

    model = get_model("uresnet", sd, policy=Policy.f32(), device="cpu",
                      train=True)
    opt = optimizers.make_optimizer(model.parameters(), opt_name, MA_LR,
                                    momentum=0.0)
    state = create_train_state(model, opt)
    sharded = []
    if mesh is not None:
        sharded = sorted(make_param_shardings(model, mesh, MA_MIN))
        state = shard_state(state, mesh, MA_MIN)
    step = build_train_step(num_classes=3, device="cpu", mesh=mesh)
    state, metrics = step(state, batch)
    names = {id(p): k for k, p in model.named_parameters()}
    own = {names[id(p)]: {k: v.clone() for k, v in st.items()
                          if torch.is_tensor(v) and v.dim()}
           for p, st in opt.opt.state.items()}
    return {"metrics": metrics, "sharded": sharded,
            "sd": {k: v.detach().clone() for k, v in
                   whole_state_dict(model).items()},
            "opt": whole_optimizer_state(state)["torch"]["state"],
            "own": own, "bytes": param_state_bytes(state)}


def model_axis_world(rank, out, model_axis, trainer):
    """Rank ``rank`` of a gloo world on a (world / model_axis,
    model_axis) mesh: an SGD and an Adam step of ``ma_step`` on its data
    index's share of the global batch, then (``trainer``) the trainer's
    checkpoints and resume on ``<out>/cfg.json``."""
    import sys

    from ubresnet_tpu_torch.core.mesh import make_mesh
    from ubresnet_tpu_torch.parallel import distributed
    from ubresnet_tpu_torch.parallel.sharding import shard_batch

    sys.modules.setdefault("torch.utils.tensorboard", None)
    torch.set_num_threads(1)
    distributed.initialize(device="cpu")
    mesh = make_mesh(model_axis=model_axis)
    res = {"mesh": (mesh.data_size, mesh.model_size, mesh.data_rank,
                    mesh.model_rank)}
    batch = shard_batch(global_batch(b=4), mesh)
    sd = ma_state_dict()
    for opt in ("sgd", "adam"):
        res[opt] = ma_step(sd, batch, opt, mesh)
    if trainer:
        res["trainer"] = trainer_runs(rank, out)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    distributed.shutdown()
