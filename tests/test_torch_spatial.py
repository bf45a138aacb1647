"""Whole planes row-sharded over several devices (parallel/sharding.py:
row_split, halo_apply; models/uresnet.py:ZoneModel.forward_rows;
deploy/wholeview.py:WholeViewRunner(devices=...)) on the CPU, the
counterpart of the JAX package's ``plane_sharding`` and
``spatial_sharding``, over ``[cpu] * R``.

Against the port's one-device spatial plane at f32 within
1e-5·max|logit| (the row cuts change only the order of the convs'
sums), against JAX's own row-sharded runner on the 8 virtual CPU
devices at JAX's tolerance (tests/test_tiling_deploy.py:240) and
against JAX's single-device apply at 1e-5·max, at JAX's test geometry:
the tiny UResNet of tests/test_tiling_deploy.py, a 100x192 plane
padded to 128 rows, which on 8 devices fills four 32-row slabs and
leaves four empty. Every slab takes the one-device plane's routes
(the wrappers' calls counted per slab), and int8 over slabs is bit
for bit the one-device int8 plane."""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from ubresnet_tpu.core.precision import Policy as JaxPolicy
from ubresnet_tpu.deploy import WholeViewRunner as JaxWholeViewRunner
from ubresnet_tpu.models import UResNet as JaxUResNet
from ubresnet_tpu.models import UResNetConfig as JaxUResNetConfig
from ubresnet_tpu_torch.core.precision import Policy
from ubresnet_tpu_torch.deploy import WholeViewRunner
from ubresnet_tpu_torch.deploy.weights import (
    random_state_dict,
    state_dict_from_jax,
)
from ubresnet_tpu_torch.models import aspp_resnet, get_model, uresnet
from ubresnet_tpu_torch.ops import block as block_ops
from ubresnet_tpu_torch.ops import conv as conv_ops
from ubresnet_tpu_torch.ops import deconv as deconv_ops
from ubresnet_tpu_torch.ops import pool as pool_ops
from ubresnet_tpu_torch.ops.quant import calibrate
from ubresnet_tpu_torch.parallel import sharding
from ubresnet_tpu_torch.parallel.sharding import (
    row_bounds,
    row_gather,
    row_split,
    spatial_gather,
    spatial_split,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _plane():
    """JAX's test plane (test_tiling_deploy.py:225-226)."""
    img = np.random.RandomState(3).rand(100, 192).astype(np.float32) * 5
    img[img < 4.0] = 0.0
    return img


def _padded(img):
    return torch.from_numpy(np.pad(img, ((0, 28), (0, 0))))[None, ..., None]


@pytest.fixture(scope="module")
def tiny():
    """JAX's tiny f32 UResNet (inplanes 4, final_conv_kernels 4) and the
    port's f32 model on its weights."""
    model = JaxUResNet(
        config=JaxUResNetConfig(num_classes=3, input_channels=1, inplanes=4,
                                final_conv_kernels=4),
        policy=JaxPolicy.f32())
    variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 64, 64, 1)))
    port = get_model("uresnet", state_dict_from_jax(variables),
                     policy=Policy.f32(), device="cpu")
    return model, variables, port


def _close(got, want, rel):
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    assert err <= rel * float(want.abs().max()), (err, rel)


def test_row_bounds_start_at_multiples_of_32():
    assert row_bounds(128, 8) == [0, 32, 64, 96, 128, 128, 128, 128, 128]
    assert row_bounds(1024, 4) == [0, 256, 512, 768, 1024]
    assert row_bounds(160, 2) == [0, 96, 160]
    with pytest.raises(ValueError, match="multiple of 32"):
        row_bounds(100, 2)


@pytest.mark.parametrize("devices", [2, 4, 8])
def test_rows_equal_the_one_device_plane(tiny, devices):
    _, _, port = tiny
    x = _padded(_plane())
    with torch.inference_mode():
        want = port(x, logits=True)
        slabs = row_split(x, [CPU] * devices)
        got = port.forward_rows(slabs, logits=True)
    assert len(got.owned()) == min(devices, 4)
    assert got.bounds[-1] == 128 and got.halo["rows"] > 0
    _close(row_gather(got, CPU), want, 1e-5)


def test_rows_match_jax_row_sharded_runner(tiny):
    """The port's runner over [cpu] * 8 against JAX's over its 8 virtual
    devices (JAX's gate), and against JAX's single-device apply."""
    model, variables, port = tiny
    img = _plane()
    mesh = JaxMesh(np.array(jax.devices()[:8]), ("devices",))
    want = JaxWholeViewRunner(model, variables, tile_rows=64, tile_cols=64,
                              crop_batch=4, spatial_mesh=mesh
                              ).score_image(img)
    runner = WholeViewRunner(port, spatial=True, devices=[CPU] * 8)
    got = runner.score_image(img)
    assert got.shape == (100, 192, 3)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-3)
    single = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(
        _padded(img).numpy())))
    with torch.inference_mode():
        rows = row_gather(port.forward_rows(row_split(_padded(img),
                                                      [CPU] * 8)), CPU)
    _close(rows, torch.from_numpy(np.array(single)), 1e-5)


def test_batch_over_data_and_rows_over_model():
    """JAX's spatial_sharding geometry (test_sharding.py:125-139): a
    (2, 64, 64, 1) batch on a (data 2, model 4) grid — each sample's 64
    rows over four devices, two of them empty."""
    port = get_model("uresnet", random_state_dict(seed=0, inplanes=8),
                     policy=Policy.f32(), device="cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.rand(2, 64, 64, 1, generator=g)
    with torch.inference_mode():
        want = port(x)
        groups = spatial_split(x, [CPU] * 8, data=2)
        assert [len(s.owned()) for s in groups] == [2, 2]
        got = spatial_gather([port.forward_rows(s) for s in groups], CPU)
    _close(got, want, 1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        spatial_split(x, [CPU] * 6, data=4)


def _count_routes(mp, calls, slab):
    """Every kernel wrapper records (name, width, channels) under the
    slab ``slab["i"]`` being computed (None: the whole plane)."""
    for mod, name in ((conv_ops, "conv_bn_act"), (conv_ops, "conv_bn_act_s8"),
                      (block_ops, "basic_block"),
                      (block_ops, "basic_block_s8"),
                      (deconv_ops, "deconv2x"), (deconv_ops, "deconv2x_s8"),
                      (pool_ops, "maxpool3x3s2")):
        fn = getattr(mod, name)

        def counted(x, *a, _fn=fn, _name=name, **kw):
            calls[slab["i"]].append((_name, x.shape[2], x.shape[3]))
            return _fn(x, *a, **kw)

        mp.setattr(mod, name, counted)
    real = sharding.halo_apply

    def per_slab(fn, slabs, *a, **kw):
        order = iter(slabs.owned())

        def tagged(dev, *xs):
            slab["i"] = next(order)
            try:
                return fn(dev, *xs)
            finally:
                slab["i"] = None

        return real(tagged, slabs, *a, **kw)

    for mod in (uresnet, aspp_resnet):
        mp.setattr(mod, "halo_apply", per_slab)


def _int8(sd, arch, x):
    q = get_model(arch, sd, policy=Policy.int8(), device="cpu")
    q.set_quant_scales(calibrate(q, [x[..., :64, :]]))
    return q


@pytest.mark.parametrize("arch,mode", [
    ("uresnet", "bf16"), ("uresnet", "int8"), ("aspp_resnet", "bf16")])
def test_each_slab_takes_the_plane_routes(arch, mode, monkeypatch):
    """At the flagship width every non-empty slab calls the kernels the
    one-device plane calls, in its order (11 a forward), and the slabs'
    output is the plane's bit for bit (bf16 and int8: the kernels'
    plain versions are per pixel)."""
    sd = random_state_dict(seed=2, arch=arch)
    sd["conv11.weight"] = sd["conv11.weight"] * 3e-4  # unsaturated scores
    x = _padded(_plane()) * 4
    model = (_int8(sd, arch, x) if mode == "int8"
             else get_model(arch, sd, device="cpu"))
    calls, slab = collections.defaultdict(list), {"i": None}
    with monkeypatch.context() as mp, torch.inference_mode():
        _count_routes(mp, calls, slab)
        want = model(x)
        got = model.forward_rows(row_split(x, [CPU] * 4))
    assert len(calls[None]) == 11
    assert sorted(k for k in calls if k is not None) == [0, 1, 2, 3]
    for i in range(4):
        assert calls[i] == calls[None], i
    rows = row_gather(got, CPU)
    differ = int((rows != want).sum())
    agree = float((rows.argmax(-1) == want.argmax(-1)).float().mean())
    near = float(((rows.exp() - want.exp()).abs() <= 2e-3).float().mean())
    assert agree > 0.995 and near >= 0.995  # JAX's int8 gate
    assert differ == 0, f"{differ} of {rows.numel()} log-probs differ"


def test_aspp_rows_equal_the_one_device_plane():
    port = get_model("aspp_resnet", random_state_dict(seed=2,
                                                      arch="aspp_resnet"),
                     policy=Policy.f32(), device="cpu")
    x = _padded(_plane())
    with torch.inference_mode():
        want = port(x, logits=True)
        got = port.forward_rows(row_split(x, [CPU] * 4), logits=True)
    _close(row_gather(got, CPU), want, 1e-5)


def test_runner_run_writes_the_one_device_entries(tmp_path):
    """``runner.run`` with the plane over [cpu] * 4: the same producers,
    meta and ids as the one-device run, and its scores within 1e-5 (f32,
    unsaturated); a stitched runner refuses devices."""
    from ubresnet_tpu_torch.data.synthetic import make_synthetic_file
    from ubresnet_tpu_torch.data.uevt import EventFileReader

    src = make_synthetic_file(str(tmp_path / "in.uevt"), n_events=2,
                              hw=(100, 192))
    sd = random_state_dict(seed=2, inplanes=4)
    sd["conv11.weight"] = sd["conv11.weight"] * 3e-4
    model = get_model("uresnet", sd, policy=Policy.f32(), device="cpu")
    outs = []
    for devices in (None, [CPU] * 4):
        runner = WholeViewRunner(model, spatial=True, devices=devices)
        path = str(tmp_path / f"out{len(outs)}.uevt")
        runner.run(src, path, planes=[2])
        outs.append(EventFileReader(path))
    assert runner.last_halo["rows"] > 0
    one, rows = outs
    assert len(one) == len(rows) == 2
    for e in range(2):
        assert one.rse(e) == rows.rse(e)
        a, b = one.read_entry(e), rows.read_entry(e)
        assert sorted(a) == sorted(b) == ["ubsnet_plane2"]
        for ia, ib in zip(a["ubsnet_plane2"], b["ubsnet_plane2"]):
            assert ia.meta == ib.meta
            np.testing.assert_allclose(ib.pixels, ia.pixels, atol=1e-5)
    with pytest.raises(ValueError, match="stitched"):
        WholeViewRunner(model, spatial=False, devices=[CPU] * 2)
