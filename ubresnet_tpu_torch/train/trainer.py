"""Config-driven training loop (counterpart of
ubresnet_tpu/train/trainer.py; the reference's
train_ubresnet2018_wlarcv2.py main(), ln 81-294).

Loop shape as the reference's: iterate to num_iters, validate every
``valid_every``, checkpoint the best, periodically and at the end,
contain a failure by breaking the loop and still writing the final
checkpoint (wlarcv2:230-251,282-289). Batches prefetch onto the card
(sparse transfer by default); every update is guarded against
non-finite loss or gradients (train/step.py), and the run aborts once
more than ``max_nan_recoveries`` steps were skipped.

The model (``model.name``: uresnet or aspp_resnet) starts from
deploy/weights.py:random_state_dict(seed, arch=model.name), the
reference initialisation. ``model.qat`` (and ``model.qat_percentile``)
set the policy's int8 QAT (``quant_train``, ``quant_percentile``), as
the JAX trainer does; validation then runs fake-quantized too.
``model.remat`` recomputes each encoder and decoder stage in backward
(Policy.remat), ``remat`` the whole forward (train/step.py). Training
files are .uevt or larcv .root (converted once to a cached .uevt,
data/loader.py:training_paths); the C++ filler (data/native.py) serves
them when the config asks for it, and the run summary names the loader
that served (``loader``). Runs on the card unless
``device="cpu"``.

Multi-process (the ranks of ``cli/launch.py --distributed N``, after
parallel/distributed.py:initialize): one data-parallel training, one
card per process. ``train_data.batch_size`` is per process, so the
global batch is batch × world (JAX trainer.py:129-142); each rank's
loaders draw seed + rank·7919 (validation + 1, JAX :182-184), for the
Python loader and the C++ filler alike; the step reduces gradients, BN
moments and metrics over the ranks (train/step.py). Before the first
collective every rank loads its first batch and builds the kernel
library, then meets the others at ``barrier("first_step_compiled")``,
so a cold nvcc build never runs into a collective's timeout; then
``shard_state`` gives every rank rank 0's weights. Only rank 0 writes
checkpoints and scalars, the others wait at a barrier after each save;
on resume every rank reads the same checkpoint. A rank that fails
saves (rank 0) and leaves without waiting for its peers, which the
launcher's gang kill then ends. ``fault_at_iter`` hard-exits rank 0
once, as in JAX. Several cards visible to one process: the port trains
on one of them (one process per card is its idiom; JAX spreads one
process over them) and says how to use them all.

``model_axis`` M > 1 lays a (world / M, M) mesh over the ranks
(core/mesh.py): the weights with ``tp_min_features`` or more output
channels are sharded by output channel over each model group, with
their Adam moments (parallel/sharding.py). The M ranks of one data
index load the same shard, from seed + data index·7919, so the global
batch is batch × world / M; BatchNorm moments, gradients and metrics
are reduced over the data group. Rank 0 gathers the slices to write the
checkpoint one process writes, and a resume slices it again.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import sys
import time
import traceback

import numpy as np
import torch

from ubresnet_tpu_torch.core.config import DataConfig, TrainConfig
from ubresnet_tpu_torch.core.mesh import make_mesh
from ubresnet_tpu_torch.core.precision import Policy
from ubresnet_tpu_torch.data.augment import mirror, pad_and_crop
from ubresnet_tpu_torch.data.loader import (
    BatchLoader,
    DevicePrefetcher,
    SegmentDataset,
    training_paths,
)
from ubresnet_tpu_torch.deploy.weights import random_state_dict
from ubresnet_tpu_torch.models import MODEL_REGISTRY, get_model
from ubresnet_tpu_torch.parallel import distributed
from ubresnet_tpu_torch.parallel.sharding import (
    param_state_bytes,
    shard_state,
    whole_optimizer_state,
    whole_state_dict,
)
from ubresnet_tpu_torch.train.checkpoint import (
    checkpoint_path,
    latest_step,
    prune_checkpoints,
    restore_checkpoint,
    save_checkpoint,
)
from ubresnet_tpu_torch.train.logging import ScalarWriter
from ubresnet_tpu_torch.train.metrics import MeterDict
from ubresnet_tpu_torch.train.optimizers import optimizer_from_config
from ubresnet_tpu_torch.train.step import (
    build_eval_step,
    build_train_step,
    create_train_state,
)
from ubresnet_tpu_torch.utils.platform import resolve_device, strict_f32


def make_loader(dcfg: DataConfig, seed: int = 0):
    """The C++ threaded filler (data/native.py) when the config asks
    for it (``native``) and needs no Python-only augment (``pad_crop``)
    and no sequential reads (the filler is random-access only, so
    ``shuffle=False`` takes the Python path); otherwise, or when its
    library cannot be built (one line says so), the Python
    BatchLoader."""
    if dcfg.native and not dcfg.pad_crop and dcfg.shuffle:
        from ubresnet_tpu_torch.data.native import NativeBatchLoader

        try:
            return NativeBatchLoader(
                training_paths(dcfg.files), batch_size=dcfg.batch_size,
                image_producer=dcfg.image_producer,
                label_producer=dcfg.label_producer,
                weight_producer=dcfg.weight_producer,
                plane=-1 if dcfg.plane is None else dcfg.plane,
                n_threads=dcfg.n_threads, n_buffers=dcfg.n_buffers,
                mirror=dcfg.mirror, adc_threshold=dcfg.adc_threshold,
                class_map=dcfg.class_map, seed=seed)
        except RuntimeError as e:  # no toolchain, build failed
            print(f"native loader unavailable ({e}); using Python loader",
                  flush=True)
    ds = SegmentDataset(dcfg.files, image_producer=dcfg.image_producer,
                        label_producer=dcfg.label_producer,
                        weight_producer=dcfg.weight_producer,
                        plane=dcfg.plane, class_map=dcfg.class_map,
                        adc_threshold=dcfg.adc_threshold)
    augment = None
    if dcfg.mirror and dcfg.pad_crop:
        def augment(b, r):
            return mirror(pad_and_crop(b, r, pad=dcfg.pad_crop), r)
    elif dcfg.mirror:
        augment = mirror
    elif dcfg.pad_crop:
        augment = functools.partial(pad_and_crop, pad=dcfg.pad_crop)
    return BatchLoader(ds, batch_size=dcfg.batch_size,
                       n_threads=dcfg.n_threads, n_buffers=dcfg.n_buffers,
                       augment=augment, shuffle=dcfg.shuffle, seed=seed)


def _refuse_unported(cfg: TrainConfig) -> None:
    if cfg.model.name not in MODEL_REGISTRY:
        raise NotImplementedError(f"model '{cfg.model.name}' is not in the "
                                  f"port (it has {sorted(MODEL_REGISTRY)})")


class Trainer:
    def __init__(self, cfg: TrainConfig, device=None):
        _refuse_unported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = make_mesh(model_axis=cfg.model_axis)
        self.rank = distributed.process_index()
        self.world = distributed.process_count()
        if (not distributed.is_initialized() and self.device.type == "cuda"
                and torch.cuda.device_count() > 1):
            n = torch.cuda.device_count()
            print(f"trainer: {n} cards visible, training on "
                  f"{self.device}; one process per card: python -m "
                  f"ubresnet_tpu_torch.cli.launch --distributed {n} "
                  "--config ...", flush=True)
        policy = Policy.f32() if cfg.model.precision == "f32" else Policy()
        if cfg.model.qat:  # ubresnet_tpu/train/trainer.py:104-117
            policy = dataclasses.replace(
                policy, quant_train=True,
                quant_percentile=cfg.model.qat_percentile)
        if cfg.model.remat:
            policy = dataclasses.replace(policy, remat=True)
        if cfg.model.precision == "f32" and self.device.type == "cuda":
            strict_f32()
        self.policy = policy
        sd = random_state_dict(cfg.seed, inplanes=cfg.model.inplanes,
                               input_channels=cfg.model.input_channels,
                               num_classes=cfg.model.num_classes,
                               arch=cfg.model.name)
        self.model = get_model(cfg.model.name, sd, policy=policy,
                               device=self.device, train=True)
        self.optimizer = optimizer_from_config(cfg.optim,
                                               self.model.parameters())
        self.writer = ScalarWriter(cfg.log_dir if self.rank == 0 else None)
        self.eval_step = build_eval_step(num_classes=cfg.model.num_classes,
                                         device=self.device, mesh=self.mesh)

    def _train_step(self, sparse_hw):
        # same function as the plain loss (JAX's trainer never uses its kernel)
        return build_train_step(num_classes=self.cfg.model.num_classes,
                                use_pallas_loss=self.policy.fused_train,
                                sparse_hw=sparse_hw,
                                accum_steps=self.cfg.accum_steps,
                                remat=self.cfg.remat, device=self.device,
                                mesh=self.mesh)

    def _saved(self, what: str) -> None:
        """After rank 0's save: every rank meets the others."""
        if self.world > 1:
            distributed.barrier(what)

    def run(self) -> dict:
        cfg = self.cfg
        # each data index draws its own stream: its share of the global
        # batch (the ranks of one model group load the same one)
        pseed = cfg.seed + self.mesh.data_rank * 7919
        train_loader = make_loader(cfg.train_data, seed=pseed).start()
        valid_loader = (make_loader(cfg.valid_data, seed=pseed + 1).start()
                        if cfg.valid_data else None)
        prefetcher = DevicePrefetcher(train_loader, self.device,
                                      sparse_bucket=cfg.train_data.sparse_bucket)
        train_iter = iter(prefetcher)
        # validation stays on the dense path (infrequent)
        valid_iter = (iter(DevicePrefetcher(valid_loader, self.device))
                      if valid_loader else None)
        # the first batch fixes the sparse image size; it is iteration 0
        first = next(train_iter)
        train_step = self._train_step(
            prefetcher.hw if cfg.train_data.sparse_bucket else None)
        state = create_train_state(self.model, self.optimizer)
        if cfg.resume and latest_step(cfg.checkpoint_dir) is not None:
            state = restore_checkpoint(cfg.checkpoint_dir, state)
            print(f"resumed from iter {state.step}", flush=True)
        if distributed.is_initialized():
            # the first batch is loaded; build the kernels, then meet the
            # peers before the first collective (shard_state's)
            t0 = time.time()
            if self.device.type == "cuda":
                from ubresnet_tpu_torch.ops import _build

                _build.library()
            distributed.barrier("first_step_compiled")
            print(f"distributed: kernels built + peers synced in "
                  f"{time.time() - t0:.1f}s", flush=True)
        state = shard_state(state, self.mesh, cfg.tp_min_features)
        meters = MeterDict()
        best = state.best_metric
        summary = {}
        path = None
        nan_seen = 0
        n_train = (len(train_loader.dataset)
                   if isinstance(train_loader, BatchLoader)
                   else train_loader.n_entries)

        def epoch():  # as the reference counts it: iter · batch / entries
            return (state.step * cfg.train_data.batch_size
                    * self.mesh.data_size / n_train)

        try:
            it = state.step
            t_iter = time.time()
            while it < cfg.num_iters:
                t0 = time.time()
                if first is not None:
                    batch, first = first, None
                else:
                    batch = next(train_iter)
                t1 = time.time()
                state, metrics = train_step(state, batch)
                t2 = time.time()
                skipped = metrics.pop("nan_skipped")
                if skipped > nan_seen:
                    print(f"non-finite loss/grads: {skipped - nan_seen} "
                          f"step(s) skipped (total {skipped}/"
                          f"{cfg.max_nan_recoveries})", flush=True)
                    nan_seen = skipped
                    if skipped > cfg.max_nan_recoveries:
                        raise FloatingPointError(
                            f"non-finite loss at iter {it + 1} ({skipped} "
                            "steps skipped)")
                if ((it + 1) % cfg.print_every == 0
                        or it + 1 == cfg.num_iters):
                    if np.isfinite(metrics["loss"]):
                        meters.update(metrics)
                        meters.update({"time/data": t1 - t0,
                                       "time/step": t2 - t1,
                                       "time/iter": t2 - t_iter})
                        self.writer.add_scalars("train", metrics, it + 1)
                        print(f"iter {it + 1}/{cfg.num_iters} "
                              f"loss {metrics['loss']:.4f} "
                              f"acc {metrics['acc_total']:.4f} "
                              f"({(t2 - t_iter) / cfg.print_every:.3f}s/iter)",
                              flush=True)
                    t_iter = time.time()
                if valid_iter and (it + 1) % cfg.valid_every == 0:
                    vm = self.validate(state, valid_iter, cfg.valid_batches)
                    self.writer.add_scalars("valid", vm, it + 1)
                    if vm["acc_total"] > best:  # the same on every rank
                        best = state.best_metric = vm["acc_total"]
                        whole = self._whole(state)
                        if self.rank == 0:
                            save_checkpoint(cfg.checkpoint_dir, state,
                                            best=True, epoch=epoch(),
                                            whole=whole)
                        self._saved("best_checkpoint")
                if (it + 1) % cfg.checkpoint_every == 0:
                    whole = self._whole(state)
                    if self.rank == 0:
                        save_checkpoint(cfg.checkpoint_dir, state,
                                        epoch=epoch(), whole=whole)
                        prune_checkpoints(cfg.checkpoint_dir,
                                          cfg.keep_checkpoints)
                    self._saved("checkpoint")
                it += 1
                if (cfg.fault_at_iter and it == cfg.fault_at_iter
                        and self.rank == 0):
                    self._maybe_inject_fault(it)
        except Exception:
            # contain, checkpoint, report (the reference breaks the loop
            # and saves, wlarcv2:230-251)
            traceback.print_exc()
            summary["error"] = traceback.format_exc()
            sys.stdout.flush()
        finally:
            # with a model axis the file needs every rank's slices: a
            # failed run writes no final one (the last periodic stands)
            sharded = self.mesh.model_size > 1
            whole = (self._whole(state) if sharded and "error" not in summary
                     else None)
            if self.rank == 0 and (whole is not None or not sharded):
                path = save_checkpoint(cfg.checkpoint_dir, state,
                                       epoch=epoch(), whole=whole)
                prune_checkpoints(cfg.checkpoint_dir, cfg.keep_checkpoints)
            else:
                if self.rank == 0:
                    print("model axis: no final checkpoint after a "
                          "failure", flush=True)
                path = checkpoint_path(cfg.checkpoint_dir, state.step)
            # a failed rank does not wait: its peers may be blocked in a
            # collective it will never join (the launcher ends them)
            if "error" not in summary:
                self._saved("final_checkpoint")
            train_loader.stop()
            if valid_loader:
                valid_loader.stop()
            self.writer.close()
        from ubresnet_tpu_torch import ops

        summary.update({
            "loader": type(train_loader).__name__,
            "process": [self.rank, self.world],
            "mesh": [self.mesh.data_size, self.mesh.model_size],
            "param_state_bytes": param_state_bytes(state),
            "kernel_launches": ops.launch_counts(),
            "final_checkpoint": path,
            "final_iter": state.step,
            "best_acc": best,
            "nan_steps_skipped": state.nan_count,
            "meters": meters.averages(),
        })
        return summary

    def _whole(self, state):
        """The whole weights and optimizer moments for a checkpoint, with
        a model axis (a collective of every rank), else None."""
        if self.mesh.model_size == 1:
            return None
        return (whole_state_dict(state.model),
                whole_optimizer_state(state))

    def _maybe_inject_fault(self, it: int):
        """One-shot hard exit (no cleanup, no final checkpoint). The
        marker file lets the resumed run pass the same iteration."""
        marker = os.path.join(os.path.abspath(self.cfg.checkpoint_dir),
                              ".fault_injected")
        if os.path.exists(marker):
            return
        os.makedirs(os.path.dirname(marker), exist_ok=True)
        with open(marker, "w") as f:
            f.write(str(it))
        print(f"fault injection: hard exit after iter {it}", flush=True)
        os._exit(23)

    def validate(self, state, valid_iter, n_batches: int) -> dict:
        meters = MeterDict()
        for _ in range(n_batches):
            meters.update(self.eval_step(state, next(valid_iter)))
        return meters.averages()


def train(cfg: TrainConfig, device=None) -> dict:
    return Trainer(cfg, device=device).run()
