"""The model axis (channel sharding) of the port's training
(core/mesh.py:make_mesh, parallel/sharding.py:make_param_shardings,
shard_state, ModelShard, whole_state_dict; the step, the trainer and its
checkpoints) in gloo worlds on the CPU, one spawned world per geometry
(tests/torch_dist_workers.py:model_axis_world): (data 1, model 2) and
(data 2, model 2).

At JAX's geometry (tests/test_sharding.py:test_model_axis_sharding_matches:
inplanes 8, 32x32, global batch 4, min_features 32, f32, SGD lr 1e-3
without momentum) each world's step is held against one port process
and against JAX's (data 4, model 2) step on 8 virtual devices at JAX's
tolerances: loss rtol 1e-5, updated parameters rtol 1e-3 and atol 2e-4.
The sharded set is JAX's, mapped to reference keys through its
exporter. An Adam step's sharded moments are the one-process moments'
slices; the BatchNorm running stats are one process's, which moments
summed over the world (each data index counted twice) would miss; rank
0 writes the checkpoint one process writes, and a resume slices it
again."""
import json
import re
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from ubresnet_tpu.core.mesh import make_mesh as jax_make_mesh
from ubresnet_tpu.core.precision import Policy as JaxPolicy
from ubresnet_tpu.deploy import importers
from ubresnet_tpu.models import get_model as jax_get_model
from ubresnet_tpu.parallel import make_param_shardings as jax_shardings
from ubresnet_tpu.parallel import shard_batch as jax_shard_batch
from ubresnet_tpu.parallel import shard_state as jax_shard_state
from ubresnet_tpu.train import optimizers as jax_opt
from ubresnet_tpu.train import step as jax_step
from ubresnet_tpu_torch.core.mesh import Mesh
from ubresnet_tpu_torch.deploy.weights import (
    random_state_dict,
    state_dict_from_jax,
)
from ubresnet_tpu_torch.models import get_model
from ubresnet_tpu_torch.parallel.sharding import make_param_shardings

torch.set_num_threads(1)

GEOMETRIES = {"1x2": 2, "2x2": 4}  # world size of (data, model 2)


def _trainer_cfg(out, data, **extra):
    cfg = {"model": {"precision": "f32", "inplanes": 4},
           "optim": {"name": "sgd", "lr": 1e-3, "momentum": 0.9},
           "train_data": {"files": [data], "batch_size": 2, "n_threads": 1,
                          "native": False},
           "valid_data": {"files": [data], "batch_size": 2, "n_threads": 1,
                          "native": False},
           "num_iters": 2, "print_every": 1, "valid_every": 1,
           "valid_batches": 1, "checkpoint_every": 1,
           "checkpoint_dir": str(out / "ck"), "log_dir": str(out / "log"),
           "seed": 3, "tp_min_features": 32, **extra}
    (out / "cfg.json").write_text(json.dumps(cfg))


@pytest.fixture(scope="module", autouse=True)
def worlds_started(tmp_path_factory):
    """Starts both worlds in the background when the module starts (they
    overlap JAX's compile); ``worlds`` waits for them."""
    from ubresnet_tpu_torch.data.synthetic import make_synthetic_file

    root = tmp_path_factory.mktemp("model_axis")
    data = make_synthetic_file(str(root / "d.uevt"), n_events=8,
                               hw=(32, 32))
    runs = {}
    for name, world in GEOMETRIES.items():
        out = root / name
        out.mkdir()
        _trainer_cfg(out, data, model_axis=2)
        errors = []

        def run(out=out, world=world, errors=errors):
            try:
                workers.run_spawned(workers.model_axis_world, world,
                                    (str(out), 2, world == 2),
                                    timeout_s=300)
            except BaseException as e:  # re-raised by ``worlds``
                errors.append(e)

        thread = threading.Thread(target=run, daemon=True)
        thread.start()
        runs[name] = (thread, errors, out, world)
    yield runs, root, data
    for thread, *_ in runs.values():
        thread.join()


@pytest.fixture(scope="module")
def worlds(worlds_started):
    runs, root, data = worlds_started
    res = {}
    for name, (thread, errors, out, world) in runs.items():
        thread.join(timeout=360)
        if errors:
            raise errors[0]
        res[name] = [torch.load(out / f"rank{r}.pt", weights_only=False)
                     for r in range(world)]
    return res


@pytest.fixture(scope="module")
def one_process():
    sd, batch = workers.ma_state_dict(), workers.global_batch(b=4)
    return {opt: workers.ma_step(sd, batch, opt) for opt in ("sgd", "adam")}


@pytest.fixture(scope="module")
def jax_sgd_step():
    """JAX's (data 4, model 2) SGD step on the port's weights and batch:
    its loss and updated state_dict."""
    variables = importers.import_uresnet_state_dict(
        {k: v.numpy() for k, v in workers.ma_state_dict().items()})
    model = jax_get_model("uresnet", policy=JaxPolicy.f32(),
                          input_channels=1, inplanes=workers.MA_INPLANES)
    tx = jax_opt.make_optimizer("sgd", learning_rate=workers.MA_LR,
                                momentum=0.0)
    state = jax_step.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]),
        best_metric=jnp.zeros((), jnp.float32),
        nan_count=jnp.zeros((), jnp.int32), apply_fn=model.apply, tx=tx)
    batch = {k: jnp.asarray(v) for k, v in workers.global_batch(b=4).items()}
    mesh = jax_make_mesh(jax.devices()[:8], model_axis=2)
    with mesh:
        st = jax_shard_state(state, mesh, min_features=workers.MA_MIN)
        new, metrics = jax_step.build_train_step(num_classes=3, donate=False)(
            st, jax_shard_batch(batch, mesh))
    return float(metrics["loss"]), state_dict_from_jax(
        {"params": new.params, "batch_stats": new.batch_stats})


def _jax_sharded_keys(inplanes, min_features):
    """The reference keys of the leaves JAX's make_param_shardings puts on
    the model axis: its tree marked (ones sharded, zeros not) through
    the exporter."""
    sd = random_state_dict(seed=0, inplanes=inplanes)
    variables = importers.import_uresnet_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    mesh = jax_make_mesh(jax.devices()[:2], model_axis=2)
    specs = jax_shardings(variables["params"], mesh, min_features)
    marked = jax.tree_util.tree_map(
        lambda p, s: np.full(p.shape, "model" in str(s.spec), np.float32),
        variables["params"], specs)
    out = state_dict_from_jax({"params": marked,
                               "batch_stats": variables["batch_stats"]})
    return sorted(k for k, v in out.items()
                  if k.endswith(".weight") and v.numel() and bool(v.all()))


@pytest.mark.parametrize("inplanes,min_features", [(16, 256), (8, 32)])
def test_param_shardings_are_jaxs(inplanes, min_features):
    """The sharded set equals JAX's by reference key: a Conv2d shards
    dim 0 (co, ci, k, k), a ConvTranspose2d dim 1 (ci, co, k, k). At the
    flagship with 256 it is enc4's, enc5's and dec5's weights, none of
    the kernel zone."""
    model = get_model("uresnet", random_state_dict(seed=0,
                                                   inplanes=inplanes),
                      device="cpu", train=True)
    got = make_param_shardings(model, Mesh(2, 0, None, 2), min_features)
    assert sorted(got) == _jax_sharded_keys(inplanes, min_features)
    for k, dim in got.items():
        assert dim == (1 if k.endswith("deconv.weight") else 0), k
    if inplanes == 16:
        assert got and all(re.match(r"(enc_layer[45]|dec_layer5)\.", k)
                           for k in got)
        assert make_param_shardings(model, Mesh(2, 0, None, 1), 32) == {}


def _assert_params(sd, want, what):
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            continue
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-3,
                                   atol=2e-4, err_msg=f"{what}: {k}")


def _assert_stats(got, want):
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        err = float((got[k].double() - want[k].double()).abs().max())
        assert err <= 5e-5 * float(want[k].double().abs().max()), (k, err)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_sgd_step_matches_one_process_and_jax(jax_sgd_step, one_process,
                                              worlds, geometry):
    # JAX's compile and the one process first: they run while the
    # spawned worlds do
    ranks = worlds[geometry]
    world = len(ranks)
    assert [r["mesh"] for r in ranks] == [
        (world // 2, 2, r // 2, r % 2) for r in range(world)]
    one = one_process["sgd"]
    jax_loss, jax_sd = jax_sgd_step
    for r in ranks:
        got = r["sgd"]
        assert got["sharded"] == sorted(make_param_shardings(
            get_model("uresnet", workers.ma_state_dict(), device="cpu",
                      train=True), Mesh(2, 0, None, 2), workers.MA_MIN))
        assert got["metrics"]["nan_skipped"] == 0
        np.testing.assert_allclose(got["metrics"]["loss"],
                                   one["metrics"]["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["metrics"]["loss"], jax_loss,
                                   rtol=1e-5)
        _assert_params(got["sd"], one["sd"], "vs one process")
        _assert_params(got["sd"], jax_sd, "vs JAX (4, 2)")
    np.testing.assert_allclose(one["metrics"]["loss"], jax_loss, rtol=1e-5)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_bn_running_stats_are_one_process(worlds, one_process, geometry):
    for r in worlds[geometry]:
        _assert_stats(r["sgd"]["sd"], one_process["sgd"]["sd"])


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_adam_moments_are_the_one_process_slices(worlds, one_process,
                                                 geometry):
    """Each rank's Adam moments: its slice of a sharded weight's (the
    one-process moments narrowed along its output channels), a
    replicated weight's whole, within 1e-4 of the moments' largest (the
    ranks' sums differ from one process's in order alone). Each rank
    holds the replicated bytes and 1/2 of the sharded ones."""
    one = one_process["adam"]
    params = dict(get_model("uresnet", workers.ma_state_dict(),
                            device="cpu", train=True).named_parameters())
    # the moments of a whole-network scale: a conv bias under BN has a
    # gradient of cancellation noise, which no relative bound holds
    scale = {k: max(float(m[k].abs().max()) for m in one["own"].values())
             for k in ("exp_avg", "exp_avg_sq")}
    for r in worlds[geometry]:
        got, m = r["adam"], r["mesh"][3]
        sharded = set(got["sharded"])
        for name, moments in got["own"].items():
            whole = one["own"][name]
            dim = 1 if name.endswith("deconv.weight") else 0
            for k, v in moments.items():
                want = whole[k]
                if name in sharded:
                    n = want.shape[dim] // 2
                    want = want.narrow(dim, m * n, n)
                assert v.shape == want.shape, (name, k)
                assert float((v - want).abs().max()) <= 1e-4 * scale[k], (
                    name, k)
        rep = sum(p.numel() for k, p in params.items() if k not in sharded)
        shd = sum(params[k].numel() for k in sharded)
        assert got["bytes"] == 4 * 3 * (rep + shd // 2)
        assert one["bytes"] == 4 * 3 * (rep + shd)


def _assert_tar(got, want, what):
    assert got["iter"] == want["iter"], what
    _assert_params(got["state_dict"], want["state_dict"], what)
    _assert_stats(got["state_dict"], want["state_dict"])
    # the moments within 1e-4 of their largest, as in the Adam test
    moments = want["optimizer"]["torch"]["state"]
    scale = max(float(v.abs().max()) for st in moments.values()
                for v in st.values() if torch.is_tensor(v))
    for i, st in moments.items():
        for k, v in st.items():
            err = float((got["optimizer"]["torch"]["state"][i][k]
                         - v).abs().max())
            assert err <= 1e-4 * scale, (what, i, k, err, scale)


def test_rank0_writes_one_process_checkpoint_and_resume_slices_it(
        worlds, worlds_started, tmp_path, monkeypatch):
    """The (1, 2) world's trainer (inplanes 4, tp_min_features 32, SGD,
    validation each iteration, 2 iterations then a resume to 3): rank 0
    alone writes; its first file is the one-process trainer's on the same
    config, and the file its resume wrote is what one process resumed
    from its second file writes (the random network amplifies the
    ranks' f32 sum order over further steps, so each comparison starts
    from one state); the last file's sharded weights are the two ranks'
    slices concatenated bit for bit."""
    import shutil

    from ubresnet_tpu_torch.core.config import TrainConfig
    from ubresnet_tpu_torch.train.trainer import Trainer

    # the JSONL log is what is kept; TensorBoard's import pulls in
    # TensorFlow where it is installed (~10 s), as in the ranks
    if "torch.utils.tensorboard" not in sys.modules:
        monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    runs, root, data = worlds_started
    t = [r["trainer"] for r in worlds["1x2"]]
    assert t[0]["writes"] and t[1]["writes"] == []
    for r in t:
        first, resumed = r["runs"]
        assert "error" not in first["summary"]
        assert first["summary"]["mesh"] == [1, 2]
        assert resumed["summary"]["final_iter"] == 3
    ck = runs["1x2"][2] / "ck"
    _trainer_cfg(tmp_path, data)
    base = json.loads((tmp_path / "cfg.json").read_text())
    one = tmp_path / "ck"
    Trainer(TrainConfig.from_dict(dict(base, num_iters=1)),
            device="cpu").run()
    name = "step_00000001.tar"
    _assert_tar(torch.load(ck / name, weights_only=False),
                torch.load(one / name, weights_only=False), name)
    shutil.copy(ck / "step_00000002.tar", one)
    summary = Trainer(TrainConfig.from_dict(dict(base, num_iters=3,
                                                 resume=True)),
                      device="cpu").run()
    assert summary["final_iter"] == 3 and "error" not in summary
    name = "step_00000003.tar"
    final = torch.load(ck / name, weights_only=False)
    _assert_tar(final, torch.load(one / name, weights_only=False), name)
    slices = [r["runs"][1]["params"] for r in t]
    sharded = 0
    for k, v in final["state_dict"].items():
        if slices[0][k].shape != v.shape:
            dim = 1 if k.endswith("deconv.weight") else 0
            assert torch.equal(torch.cat([s[k] for s in slices], dim), v), k
            sharded += 1
        else:
            assert torch.equal(slices[0][k], v), k
    assert sharded > 0
