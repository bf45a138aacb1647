"""Precropped deploy, file → score → file: the port's CLI
(ubresnet_tpu_torch.cli.infer_precropped, --device cpu) against the
JAX package's CLI on the same synthetic .uevt and the same reference
.tar, both in float32. Labels must agree on ≥ 99.9% of pixels and each
package must read the other's output file."""
import dataclasses

import numpy as np
import pytest
import torch

from ubresnet_tpu.cli.infer_precropped import main as jax_main
from ubresnet_tpu.data.uevt import EventFileReader as JaxReader
from ubresnet_tpu.parity.torch_oracle import make_state_dict
from ubresnet_tpu_torch.cli.infer_precropped import main as port_main
from ubresnet_tpu_torch.data.rootio import open_event_file
from ubresnet_tpu_torch.data.synthetic import make_synthetic_file
from ubresnet_tpu_torch.data.uevt import EventFileReader as PortReader
from ubresnet_tpu_torch.deploy.weights import save_reference_checkpoint

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("precropped")
    data = make_synthetic_file(str(d / "in.uevt"), n_events=4, hw=(64, 64),
                               seed=5)
    sd = make_state_dict(np.random.RandomState(7), inplanes=16)
    ckpt = save_reference_checkpoint(sd, str(d / "ref.tar"))
    return d, data, ckpt


def _scores(reader, i):
    imgs = reader.read_entry(i)["uburn_plane2"]
    return np.stack([im.pixels.astype(np.float32) for im in imgs], -1), imgs


def test_port_cli_matches_jax_cli(files):
    d, data, ckpt = files
    out_jax, out_port = str(d / "jax.uevt"), str(d / "port.uevt")
    common = ["-i", data, "-c", ckpt, "-b", "3", "--f32"]
    assert jax_main(common + ["-o", out_jax]) == 0
    assert port_main(common + ["-o", out_port, "--device", "cpu"]) == 0
    # each package reads the other's file
    a, b = PortReader(out_jax), JaxReader(out_port)
    assert len(a) == len(b) == 4
    src = PortReader(data)
    labels_a, labels_b = [], []
    for i in range(4):
        sa, imgs_a = _scores(a, i)
        sb, imgs_b = _scores(b, i)
        assert len(imgs_a) == len(imgs_b) == 3
        assert imgs_b[0].rse == src.rse(i) == imgs_a[0].rse
        assert (dataclasses.astuple(imgs_b[0].meta)
                == dataclasses.astuple(imgs_a[0].meta))
        np.testing.assert_allclose(sb.sum(-1), 1.0, atol=1e-4)
        labels_a.append(sa.argmax(-1))
        labels_b.append(sb.argmax(-1))
    agree = float((np.stack(labels_a) == np.stack(labels_b)).mean())
    assert agree >= 0.999, agree


@pytest.mark.parametrize("mode,atol", [("f16", 2e-3), ("u8", 6e-3)])
def test_port_compact_readback_and_f16_scores(files, mode, atol):
    """Compact device→host forms rebuild the dropped class; f16 score
    files halve the bytes; the tail batch (4 events at -b 3) is padded
    and its padding never written."""
    d, data, ckpt = files
    ref, out = str(d / f"ref_{mode}.uevt"), str(d / f"c_{mode}.uevt")
    base = ["-i", data, "-c", ckpt, "-b", "3", "--device", "cpu"]
    port_main(base + ["-o", ref])
    port_main(base + ["-o", out, "--compact-readback", mode, "--f16-scores"])
    r0, r1 = PortReader(ref), PortReader(out)
    assert len(r1) == 4
    for i in range(4):
        s0, _ = _scores(r0, i)
        s1, imgs = _scores(r1, i)
        assert imgs[0].pixels.dtype == np.float16
        np.testing.assert_allclose(s1, s0, atol=atol)


def test_port_refuses_root_files(files):
    """larcv .root in and out: a .root output holds the .uevt run's
    float32 scores under uburn_plane2 and reads back as input; a file
    that is not ROOT inside is refused by the reader."""
    d, data, ckpt = files
    base = ["-c", ckpt, "-b", "3", "--f32", "--device", "cpu"]
    out_root, out_uevt = str(d / "x.root"), str(d / "x.uevt")
    port_main(["-i", data, "-o", out_root, "--f16-scores"] + base)
    port_main(["-i", data, "-o", out_uevt] + base)
    root, uevt = open_event_file(out_root), PortReader(out_uevt)
    assert len(root) == len(uevt) == 4
    for i in range(4):
        s_root, imgs = _scores(root, i)
        assert imgs[0].pixels.dtype == np.float32
        assert imgs[0].rse == uevt.rse(i)
        np.testing.assert_array_equal(s_root, _scores(uevt, i)[0])
    port_main(["-i", out_root, "-o", str(d / "y.uevt"), "-t",
               "uburn_plane2"] + base)
    fake = d / "fake.root"
    fake.write_bytes(b"not a ROOT file")
    with pytest.raises(OSError, match="cannot open ROOT file"):
        port_main(["-i", str(fake), "-o", str(d / "z.uevt")] + base)


def test_port_cli_takes_the_jax_flags(files):
    """The JAX CLI's --arch, --config, --best, --data-parallel and
    --trace parse: --arch aspp_resnet scores an ASPP .tar and exits on
    this UResNet .tar naming the missing ASPP keys, --config and --best
    on a .tar exit naming the checkpoint directories they pick from
    (tests/test_torch_checkpoint_dirs.py loads those), --trace writes a
    torch.profiler trace of the run, --data-parallel on one device
    writes the same bytes as without it."""
    import json

    from ubresnet_tpu_torch.deploy.weights import random_state_dict

    d, data, ckpt = files
    base = ["-i", data, "-o", str(d / "flags.uevt"), "-c", ckpt,
            "--device", "cpu", "--f32"]
    for extra, item in ((["--arch", "aspp_resnet"], "ASPP_layer_enc3"),
                        (["--config", "c.json"], "checkpoint directory"),
                        (["--best"], "checkpoint directory"),
                        (["--best"], "step_<N>.tar, best.tar")):
        with pytest.raises(SystemExit, match=item):
            port_main(base + extra)
    aspp = save_reference_checkpoint(
        random_state_dict(seed=0, arch="aspp_resnet"), str(d / "aspp.tar"))
    assert port_main(["-i", data, "-o", str(d / "aspp.uevt"), "-c", aspp,
                      "--device", "cpu", "--arch", "aspp_resnet"]) == 0
    scores = np.stack([_scores(PortReader(str(d / "aspp.uevt")), i)[0]
                       for i in range(4)])
    assert scores.shape == (4, 64, 64, 3) and np.isfinite(scores).all()
    np.testing.assert_allclose(scores.sum(-1), 1.0, atol=1e-2)
    assert port_main(base + ["--arch", "uresnet", "--trace",
                             str(d / "trace")]) == 0
    events = json.loads((d / "trace" / "trace.json").read_text())[
        "traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert len(PortReader(str(d / "flags.uevt"))) == 4
    dp = str(d / "flags_dp.uevt")
    assert port_main(base[:2] + ["-o", dp] + base[4:]
                     + ["--data-parallel"]) == 0
    with open(dp, "rb") as a, open(d / "flags.uevt", "rb") as b:
        assert a.read() == b.read()


def _crops_with(charges, hw=64, seed=11):
    """(len(charges), hw, hw, 1) float32 crops with exactly ``n``
    charged pixels each (distinct positions)."""
    rng = np.random.RandomState(seed)
    out = np.zeros((len(charges), hw * hw), np.float32)
    for i, n in enumerate(charges):
        px = rng.choice(hw * hw, size=n, replace=False)
        out[i, px] = rng.uniform(20.0, 80.0, size=n)
    return out.reshape(len(charges), hw, hw, 1)


@pytest.mark.parametrize("order", ["grows", "below"])
def test_runner_capacity_follows_batches_as_dense(monkeypatch, order):
    """The runner's COO width across batches, at a 64-pixel grain: a
    later batch whose k exceeds the capacity an earlier one set widens
    it ("grows"); one whose k is below is shipped at the capacity
    ("below"). The scores equal the dense transfer's on every batch,
    and no ``np.pad`` runs."""
    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.deploy import precropped
    from ubresnet_tpu_torch.deploy.weights import random_state_dict
    from ubresnet_tpu_torch.models import get_model

    def no_pad(*a, **k):
        raise AssertionError("np.pad on the runner's path")

    monkeypatch.setattr(precropped, "SPARSE_BUCKET", 64)
    monkeypatch.setattr(np, "pad", no_pad)
    shipped = []

    def to_device(a, device):
        shipped.append(a.shape)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    monkeypatch.setattr(precropped, "to_device", to_device)
    model = get_model("uresnet", random_state_dict(seed=3),
                      policy=Policy.f32(), device="cpu")
    sparse = precropped.PrecroppedRunner(model, batch_size=2)
    dense = precropped.PrecroppedRunner(model, batch_size=2, sparse=False)
    small, big = _crops_with([10, 40]), _crops_with([300, 120], seed=12)
    batches, caps = (([small, big], [64, 320]) if order == "grows"
                     else ([big, small], [320, 320]))
    for batch, cap in zip(batches, caps):
        shipped.clear()
        got = sparse._fetch(sparse._dispatch(batch), 2, (64, 64))
        assert sparse._cap == cap
        assert shipped == [(2, cap), (2, cap)]  # indices, values
        want = dense._fetch(dense._dispatch(batch), 2, (64, 64))
        np.testing.assert_array_equal(got, want)
