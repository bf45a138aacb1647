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
``device="cpu"``. Not in the port yet, and refused: model_axis > 1 (and
multi-process runs).
"""
from __future__ import annotations

import dataclasses
import functools
import os
import sys
import time
import traceback

import numpy as np

from ubresnet_tpu_torch.core.config import DataConfig, TrainConfig
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
from ubresnet_tpu_torch.train.checkpoint import (
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
    if cfg.model_axis > 1:
        raise NotImplementedError(
            "model_axis > 1: multi-device training is not in the port yet")
    if cfg.model.name not in MODEL_REGISTRY:
        raise NotImplementedError(f"model '{cfg.model.name}' is not in the "
                                  f"port (it has {sorted(MODEL_REGISTRY)})")


class Trainer:
    def __init__(self, cfg: TrainConfig, device=None):
        _refuse_unported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
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
        self.writer = ScalarWriter(cfg.log_dir)
        self.eval_step = build_eval_step(num_classes=cfg.model.num_classes,
                                         device=self.device)

    def _train_step(self, sparse_hw):
        # same function as the plain loss (JAX's trainer never uses its kernel)
        return build_train_step(num_classes=self.cfg.model.num_classes,
                                use_pallas_loss=self.policy.fused_train,
                                sparse_hw=sparse_hw,
                                accum_steps=self.cfg.accum_steps,
                                remat=self.cfg.remat, device=self.device)

    def run(self) -> dict:
        cfg = self.cfg
        train_loader = make_loader(cfg.train_data, seed=cfg.seed).start()
        valid_loader = (make_loader(cfg.valid_data, seed=cfg.seed + 1).start()
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
        meters = MeterDict()
        best = state.best_metric
        summary = {}
        path = None
        nan_seen = 0
        n_train = (len(train_loader.dataset)
                   if isinstance(train_loader, BatchLoader)
                   else train_loader.n_entries)

        def epoch():  # as the reference counts it: iter · batch / entries
            return state.step * cfg.train_data.batch_size / n_train

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
                    if vm["acc_total"] > best:
                        best = state.best_metric = vm["acc_total"]
                        save_checkpoint(cfg.checkpoint_dir, state, best=True,
                                        epoch=epoch())
                if (it + 1) % cfg.checkpoint_every == 0:
                    save_checkpoint(cfg.checkpoint_dir, state,
                                    epoch=epoch())
                    prune_checkpoints(cfg.checkpoint_dir, cfg.keep_checkpoints)
                it += 1
                if cfg.fault_at_iter and it == cfg.fault_at_iter:
                    self._maybe_inject_fault(it)
        except Exception:
            # contain, checkpoint, report (the reference breaks the loop
            # and saves, wlarcv2:230-251)
            traceback.print_exc()
            summary["error"] = traceback.format_exc()
            sys.stdout.flush()
        finally:
            path = save_checkpoint(cfg.checkpoint_dir, state,
                                   epoch=epoch())
            prune_checkpoints(cfg.checkpoint_dir, cfg.keep_checkpoints)
            train_loader.stop()
            if valid_loader:
                valid_loader.stop()
            self.writer.close()
        summary.update({
            "loader": type(train_loader).__name__,
            "final_checkpoint": path,
            "final_iter": state.step,
            "best_acc": best,
            "nan_steps_skipped": state.nan_count,
            "meters": meters.averages(),
        })
        return summary

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
