"""int8 precropped deploy, file → score → file: the port's CLI with
``--int8 --device cpu`` (Policy.int8: bf16 compute, the kernels' plain
versions) against the JAX package's ``--int8`` CLI on the same synthetic
.uevt and reference .tar.

JAX's CLI on the CPU takes its unfused XLA int8 route (``fused_eval``
is on only on a TPU), which tests/test_quant.py:276-285 says is not
bit-identical to the fused route the port follows; so the two CLIs are
compared through each one's distance from its own f32 output, at the
JAX test's bar (mean|Δp| < 0.02, argmax agreement > 0.95), and through
the files: each package reads the other's."""
import json

import numpy as np
import pytest
import torch

from ubresnet_tpu.cli.infer_precropped import main as jax_main
from ubresnet_tpu.data.uevt import EventFileReader as JaxReader
from ubresnet_tpu_torch.cli.infer_precropped import main as port_main
from ubresnet_tpu_torch.data.synthetic import make_synthetic_file
from ubresnet_tpu_torch.data.uevt import EventFileReader as PortReader
from ubresnet_tpu_torch.deploy.weights import (
    random_state_dict,
    save_reference_checkpoint,
)

torch.set_num_threads(1)
N = 4


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("int8cli")
    data = make_synthetic_file(str(d / "in.uevt"), n_events=N, hw=(64, 64),
                               seed=5)
    ckpt = save_reference_checkpoint(random_state_dict(seed=2),
                                     str(d / "ref.tar"))
    return d, data, ckpt


def _scores(reader):
    return np.stack([np.stack([im.pixels.astype(np.float32)
                               for im in reader.read_entry(i)["uburn_plane2"]],
                              -1) for i in range(len(reader))])


def _run(main, files, name, *extra, device=True):
    d, data, ckpt = files
    out = str(d / f"{name}.uevt")
    argv = ["-i", data, "-o", out, "-c", ckpt, "-b", "2", *extra]
    assert main(argv + (["--device", "cpu"] if device else [])) == 0
    return out


def test_int8_cli_scores_and_cross_reads(files, capsys):
    port_q = _run(port_main, files, "port_q", "--int8", "-v")
    printed = capsys.readouterr().out
    assert "int8: calibrated on 4 images" in printed
    timing = json.loads(printed.strip().splitlines()[-1])
    assert timing["calibrate"] > 0 and timing["total"] > 0
    jax_q = _run(jax_main, files, "jax_q", "--int8", device=False)
    port_f = _run(port_main, files, "port_f", "--f32")
    jax_f = _run(jax_main, files, "jax_f", "--f32", device=False)
    # each package reads the other's int8 output
    sq, jq_ = _scores(JaxReader(port_q)), _scores(PortReader(jax_q))
    sf, jf = _scores(PortReader(port_f)), _scores(PortReader(jax_f))
    assert sq.shape == jq_.shape == (N, 64, 64, 3)
    np.testing.assert_allclose(sq.sum(-1), 1.0, atol=1e-2)
    np.testing.assert_allclose(jq_.sum(-1), 1.0, atol=1e-2)
    for q, f in ((sq, sf), (jq_, jf)):
        assert np.abs(q - f).mean() < 0.02
        assert (q.argmax(-1) == f.argmax(-1)).mean() > 0.95


def test_int8_cli_percentile(files):
    out = _run(port_main, files, "port_p", "--int8", "--int8-calib", "2",
               "--int8-percentile", "99.9")
    s = _scores(PortReader(out))
    assert np.isfinite(s).all()
    np.testing.assert_allclose(s.sum(-1), 1.0, atol=1e-2)


def test_int8_and_f32_exclusive(files):
    with pytest.raises(SystemExit, match="mutually exclusive"):
        _run(port_main, files, "bad", "--int8", "--f32")
