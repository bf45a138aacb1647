"""The port's data-parallel training (parallel/distributed.py,
core/mesh.py, parallel/sharding.py, the step, BatchNorm, metrics and
trainer under a process group) in a 2-rank gloo world on the CPU, run
once per module in spawned processes (tests/torch_dist_workers.py)
against one process on the same global batch and against the JAX
package's ``build_train_step`` on it (Policy.f32, the same weights: a
UResNet at inplanes 8 and depth 2, 32x32, global batch 4, SGD lr
1e-2; the trainer at inplanes 4).

Tolerances are tests/test_torch_train.py's f32 ones: loss rtol 1e-5,
every accuracy within 1e-6, running stats within 5e-5·max|stat|,
gradients within 5e-2 of the largest |grad| (train-mode BN gradients'
floor), parameters after the step within lr·5e-2·max|grad|. The 2-rank
step and the 1-process step run the same arithmetic but for the order
of the sums over the two shards, so they sit far inside these. Per-rank
BatchNorm moments (the DDP default) move the loss and the running
stats well outside them; a guard decided per rank would let rank 0
update where rank 1 skips (``test_guard_decides_once``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from ubresnet_tpu.core.precision import Policy as JaxPolicy
from ubresnet_tpu.deploy import importers
from ubresnet_tpu.models import get_model as jax_get_model
from ubresnet_tpu.train import optimizers as jax_opt
from ubresnet_tpu.train import step as jax_step
from ubresnet_tpu_torch.core.mesh import Mesh, make_mesh
from ubresnet_tpu_torch.deploy.weights import state_dict_from_jax
from ubresnet_tpu_torch.parallel import distributed
from ubresnet_tpu_torch.parallel.sharding import shard_batch
from ubresnet_tpu_torch.train.metrics import (
    accuracy_from_counts,
    pixel_accuracy,
    pixel_counts,
)

torch.set_num_threads(1)

GRAD_FLOOR = 5e-2
ENV = (distributed.COORDINATOR_ENV, distributed.NUM_PROCESSES_ENV,
       distributed.PROCESS_ID_ENV)


@pytest.fixture(scope="module", autouse=True)
def world_started(tmp_path_factory):
    """Starts torch_dist_workers.train_world on a 2-rank world in the
    background when the module starts (it overlaps JAX's compiles);
    ``world`` waits for it."""
    import json
    import threading

    from ubresnet_tpu_torch.data.synthetic import make_synthetic_file

    out = tmp_path_factory.mktemp("world")
    data = make_synthetic_file(str(out / "d.uevt"), n_events=8, hw=(32, 32))
    cfg = {"model": {"precision": "f32", "inplanes": 4},
           "optim": {"name": "adam", "lr": 1e-3},
           "train_data": {"files": [data], "batch_size": 2, "n_threads": 1,
                          "native": False},
           "valid_data": {"files": [data], "batch_size": 2, "n_threads": 1,
                          "native": False},
           "num_iters": 2, "print_every": 1, "valid_every": 1,
           "valid_batches": 1, "checkpoint_every": 1,
           "checkpoint_dir": str(out / "ck"), "log_dir": str(out / "log"),
           "seed": 3}
    (out / "cfg.json").write_text(json.dumps(cfg))
    errors = []

    def run():
        try:
            workers.run_spawned(workers.train_world, 2, (str(out),),
                                    timeout_s=240)
        except BaseException as e:  # re-raised by ``world``
            errors.append(e)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    yield thread, errors, out
    thread.join()


@pytest.fixture(scope="module")
def world(world_started):
    """Both ranks' results of torch_dist_workers.train_world, and the
    directory of its tiny trainer config."""
    thread, errors, out = world_started
    thread.join(timeout=300)
    if errors:
        raise errors[0]
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(2)], out


@pytest.fixture(scope="module")
def one_process():
    sd = workers.state_dict()
    batch = workers.global_batch()
    return {name: workers.sgd_step(sd, batch, accum)
            for name, accum in (("plain", 1), ("accum2", 2))}


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's state dict and metrics after one SGD step on the global
    batch, plain and with accum_steps 2."""
    sd = {k: v.numpy() for k, v in workers.state_dict().items()}
    # deploy/importers.py:import_uresnet_state_dict for depth 3 (it
    # spells out the five stages)
    p, s = {}, {}
    p["stem"], s["stem"] = importers._convbn(sd, "conv1", "bn1")
    for i in range(1, workers.DEPTH + 1):
        p[f"enc{i}"], s[f"enc{i}"] = importers._double_resnet(
            sd, f"enc_layer{i}")
        p[f"dec{i}"], s[f"dec{i}"] = importers._decoder(sd, f"dec_layer{i}")
    p["head"], s["head"] = importers._convbn(sd, "conv10", "bn10")
    p["classifier"] = importers._conv(sd, "conv11")
    variables = {"params": p, "batch_stats": s}
    model = jax_get_model("uresnet", policy=JaxPolicy.f32(),
                          input_channels=1, inplanes=workers.INPLANES,
                          depth=workers.DEPTH)
    tx = jax_opt.make_optimizer("sgd", learning_rate=workers.LR,
                                weight_decay=1e-3, momentum=0.9)
    batch = {k: jnp.asarray(v) for k, v in workers.global_batch().items()}
    out = {}
    for name, accum in (("plain", 1), ("accum2", 2)):
        state = jax_step.TrainState(
            step=jnp.zeros((), jnp.int32), params=variables["params"],
            batch_stats=variables["batch_stats"],
            opt_state=tx.init(variables["params"]),
            best_metric=jnp.zeros((), jnp.float32),
            nan_count=jnp.zeros((), jnp.int32), apply_fn=model.apply, tx=tx)
        new, metrics = jax_step.build_train_step(
            num_classes=3, donate=False, accum_steps=accum)(state, batch)
        out[name] = ({k: float(v) for k, v in metrics.items()},
                     state_dict_from_jax({"params": new.params,
                                          "batch_stats": new.batch_stats}))
    return out


def test_initialize_is_a_noop_without_the_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize(device="cpu") is False
    assert not distributed.is_initialized()
    assert (distributed.process_index(), distributed.process_count()) == (0, 1)
    assert distributed.is_primary() and distributed.barrier("x") is False
    mesh = make_mesh()
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    # a model axis divides the world; without a process group it has no
    # groups to shard over
    mesh = make_mesh(2, model_axis=2)
    assert (mesh.data_size, mesh.model_size, mesh.model_group) == (1, 2, None)
    with pytest.raises(ValueError, match="not divisible by model_axis"):
        make_mesh(3, model_axis=2)


def test_backend_follows_the_ranks_on_this_host(monkeypatch):
    """NCCL when every rank on a host has a card of its own, whatever
    the world size: two hosts of two cards in a world of 4 take NCCL,
    each rank the card of its index on its host; three ranks on a
    2-card host, or ranks on the CPU, take gloo."""
    from ubresnet_tpu_torch.utils import platform

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    hosts = ["a", "a", "b", "b"]
    layout = [distributed.host_layout(hosts, r) for r in range(4)]
    assert layout == [(0, 2), (1, 2), (0, 2), (1, 2)]
    cuda = torch.device("cuda", 0)
    assert {distributed.choose_backend(n, cuda) for _, n in layout} == {
        "nccl"}
    assert distributed.host_layout(["a", "a", "a", "b"], 2) == (2, 3)
    assert distributed.choose_backend(3, cuda) == "gloo"
    assert distributed.choose_backend(2, torch.device("cpu")) == "gloo"
    # rank 3 of the world is rank 1 on host b: its card is cuda:1, and
    # local rank 0 with process id 3 is cuda:0, not 3 % 2
    monkeypatch.setenv(distributed.COORDINATOR_ENV, "127.0.0.1:1")
    monkeypatch.setenv(distributed.PROCESS_ID_ENV, "3")
    try:
        for local, want in ((None, 1), (1, 1), (0, 0)):
            platform.set_local_rank(local)
            assert platform.resolve_device("cuda") == torch.device(
                "cuda", want)
        assert platform.resolve_device("cpu") == torch.device("cpu")
    finally:
        platform.set_local_rank(None)


def test_shard_batch_splits_microbatches():
    """Rank r's share: contiguous with one microbatch, else its piece of
    each microbatch in order, so the ranks' local microbatch i together
    are the global one."""
    b = {"x": np.arange(8)}
    for r, want in ((0, [0, 1, 4, 5]), (1, [2, 3, 6, 7])):
        mesh = Mesh(size=2, rank=r)
        assert shard_batch(b, mesh, 2)["x"].tolist() == want
        assert shard_batch(b, mesh)["x"].tolist() == list(range(4 * r,
                                                                4 * r + 4))


def test_accuracy_from_counts_is_the_global_batchs():
    """Summed counts give the global ratio, not the mean of per-shard
    ratios: class 1 is 1 of 1 right in one shard, 1 of 3 in the other,
    2 of 4 in all (the mean of ratios would say 2/3)."""
    labels = torch.tensor([[[1, 0, 0, 0]], [[1, 1, 1, 0]]])
    pred = torch.tensor([[[1, 1, 1, 1]], [[0, 0, 1, 1]]])
    logits = torch.nn.functional.one_hot(pred, 3).float()
    c = [pixel_counts(logits[i:i + 1], labels[i:i + 1]) for i in range(2)]
    glob = accuracy_from_counts(c[0] + c[1])
    whole = pixel_accuracy(logits, labels)
    assert float(glob["acc_class1"]) == float(whole["acc_class1"]) == 0.5
    per = [float(accuracy_from_counts(x)["acc_class1"]) for x in c]
    assert sum(per) / 2 == pytest.approx(2 / 3)
    assert {k: float(v) for k, v in glob.items()} == {
        k: float(v) for k, v in whole.items()}


def _assert_stats(got, want, tol):
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        err = float((got[k].double() - want[k].double()).abs().max())
        assert err <= tol * float(want[k].double().abs().max()), (k, err)


def _assert_step(got, want_metrics, want_sd, gsc):
    metrics, sd, _ = got
    np.testing.assert_allclose(metrics["loss"], want_metrics["loss"],
                               rtol=1e-5)
    for k, v in want_metrics.items():
        if k not in ("loss", "nan_skipped"):
            assert abs(metrics[k] - v) <= 1e-6, (k, metrics[k], v)
    _assert_stats(sd, want_sd, 5e-5)
    for k, v in want_sd.items():
        if not k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(
                sd[k].numpy(), v.numpy(), rtol=1e-5,
                atol=workers.LR * GRAD_FLOOR * gsc, err_msg=k)


@pytest.mark.parametrize("name", ["plain", "accum2"])
def test_two_rank_step_matches_one_process_and_jax(jax_steps, one_process,
                                                   world, name):
    ranks, _ = world
    m1, sd1, g1 = one_process[name]
    gsc = max(float(g.abs().max()) for g in g1.values())
    for r in ranks:
        m, sd, g = r[name]
        assert m["nan_skipped"] == 0
        _assert_step(r[name], m1, sd1, gsc)
        for k in g1:
            assert float((g[k] - g1[k]).abs().max()) <= GRAD_FLOOR * gsc, k
    # the replicas stay equal, bit for bit
    for k, v in ranks[0][name][1].items():
        assert torch.equal(v, ranks[1][name][1][k]), k
    jm, jsd = jax_steps[name]
    _assert_step(ranks[0][name], jm, jsd, gsc)
    _assert_step(one_process[name], jm, jsd, gsc)


def test_initialize_joins_a_two_rank_world(world):
    ranks, _ = world
    assert [(r["joined"], r["rank"], r["world"], r["backend"])
            for r in ranks] == [(True, 0, 2, "gloo"), (True, 1, 2, "gloo")]


def test_nan_in_one_shard_skips_on_both_ranks(world):
    ranks, _ = world
    sd0 = workers.state_dict()
    for r in ranks:
        metrics, sd, _ = r["nan"]
        assert metrics["nan_skipped"] == 1
        for k, v in sd0.items():  # parameters and running stats unchanged
            assert torch.equal(sd[k], v.float()), k
    for k, v in ranks[0]["nan"][1].items():
        assert torch.equal(v, ranks[1]["nan"][1][k]), k


def test_guard_decides_once(world):
    """The non-finite guard's decision is the MIN over the ranks: rank 1
    alone not ok makes both skip."""
    ranks, _ = world
    assert [r["guard"] for r in ranks] == [(False, True), (False, True)]


def test_zone_batchnorm_reduces_k5_sums_and_their_gradients(world):
    """K5's form (y, Σy, Σy²) under a 2-rank BatchNorm: y, the running
    stats, dx of each shard and the parameter gradients summed over the
    ranks equal one process's on the whole batch — the cotangents of
    Σy and Σy² come back summed through the all-reduce."""
    ranks, _ = world
    x, r = workers.bn_inputs()
    want = workers.bn_zone(x, r)
    got = [k["bn_zone"] for k in ranks]
    for key in ("y", "dx"):
        cat = torch.cat([g[key] for g in got])
        assert float((cat - want[key]).abs().max()) <= 1e-5 * float(
            want[key].abs().max()), key
    for key in ("mean", "var"):
        for g in got:
            torch.testing.assert_close(g[key], want[key], rtol=1e-5,
                                       atol=1e-6)
    for key in ("w", "gamma", "beta"):
        tot = got[0][key] + got[1][key]
        assert float((tot - want[key]).abs().max()) <= 1e-4 * float(
            want[key].abs().max()), key


def test_rank0_writes_checkpoints_and_both_ranks_resume(world):
    ranks, out = world
    t = [r["trainer"] for r in ranks]
    assert t[0]["writes"] and t[1]["writes"] == []
    for r in t:
        first, resumed = r["runs"]
        assert "error" not in first["summary"]
        assert first["summary"]["final_iter"] == 2
        assert resumed["summary"]["final_iter"] == 3
        assert first["summary"]["process"][1] == 2
    for k, v in t[0]["runs"][1]["params"].items():
        assert torch.equal(v, t[1]["runs"][1]["params"][k]), k
    assert sorted(p.name for p in (out / "ck").iterdir()
                  if p.name.endswith(".tar")) == [
        "best.tar", "step_00000001.tar", "step_00000002.tar",
        "step_00000003.tar"]
    logs = list((out / "log").iterdir())
    assert [p.name for p in logs if p.suffix == ".jsonl"] == ["run.jsonl"]


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_data_parallel_runner_writes_the_unsplit_bytes(tmp_path, int8):
    """``devices=["cpu", "cpu"]`` (--data-parallel's replicas, each batch
    in two equal shards, int8 calibrated once for both) writes the
    unsplit runner's bytes, the 6-event file's tail batch padded as
    before; a batch that does not divide raises as JAX's runner does."""
    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.data.synthetic import make_synthetic_file
    from ubresnet_tpu_torch.deploy import PrecroppedRunner
    from ubresnet_tpu_torch.deploy.weights import random_state_dict
    from ubresnet_tpu_torch.models import get_model

    src = make_synthetic_file(str(tmp_path / "in.uevt"), n_events=6,
                              hw=(64, 64))
    sd = random_state_dict(seed=2, inplanes=4)
    sd["conv11.weight"] = sd["conv11.weight"] * 3e-4  # unsaturated scores
    pol = (dataclasses.replace(Policy.f32(), fused_eval=True,
                               quant_eval=True) if int8 else Policy())
    model = get_model("uresnet", sd, policy=pol, device="cpu")
    out = []
    for devices in (None, ["cpu", "cpu"]):
        runner = PrecroppedRunner(model, batch_size=4, devices=devices)
        if int8:
            runner.calibrate_from(src, n_images=4)
        path = tmp_path / f"out{len(out)}.uevt"
        runner.run(src, str(path))
        out.append(path.read_bytes())
    assert len(runner.replicas) == 2 and out[0] == out[1]
    with pytest.raises(ValueError, match="must be divisible by the device"):
        PrecroppedRunner(model, batch_size=3, devices=["cpu", "cpu"])
