"""The port's conversion CLI (ubresnet_tpu_torch.cli.convert) against the
JAX package's (ubresnet_tpu.cli.convert) on the same inputs: NPZ →
.uevt, larcv .root → .uevt (all producers and --producers), .uevt →
.root (--to-root, all producers and --producers) and --inspect. Each
output, written by both CLIs to the same path (a .root file records
the path it was created at), must be the same bytes, and each CLI must
print the same."""
import numpy as np
import pytest
import torch

from root_synth import write_larcv_like
from ubresnet_tpu.cli.convert import main as jax_main
from ubresnet_tpu_torch.cli.convert import main as port_main
from ubresnet_tpu_torch.data.synthetic import make_synthetic_file
from ubresnet_tpu_torch.data.uevt import EventFileReader

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("convert")
    root = str(d / "ev.root")
    write_larcv_like(root, producers=("wire", "segment", "ts_keyspweight"),
                     n_entries=4, compression="zstd")
    uevt = make_synthetic_file(str(d / "ev.uevt"), n_events=3, hw=(32, 48),
                               seed=6)
    rng = np.random.RandomState(2)
    arrays = {}
    for i in range(3):
        for prod in ("wire", "segment"):
            arrays[f"{i}/{prod}/2"] = (rng.rand(16, 24) * 40).astype(
                np.float32)
        arrays[f"{i}/wire/2/meta"] = np.array([0.0, 0.0, 24.0, 96.0, 16,
                                               24, 2])
        if i != 1:  # entry 1 takes the default rse (0, 0, entry)
            arrays[f"{i}/rse"] = np.array([5, 1, 300 + i])
    npz = str(d / "ev.npz")
    np.savez_compressed(npz, **arrays)
    return d, {"root": root, "uevt": uevt, "npz": npz}


CASES = {
    "npz": lambda f, out: [f["npz"], out],
    "root": lambda f, out: [f["root"], out],
    "root-producers": lambda f, out: [f["root"], out, "--producers",
                                      "wire,segment", "-v"],
    "to-root": lambda f, out: ["--to-root", f["uevt"], out],
    "to-root-producers": lambda f, out: ["--to-root", f["uevt"], out,
                                         "--producers", "wire"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_outputs_bytes_equal_jax(inputs, capsys, case):
    d, files = inputs
    out = str(d / (case + (".root" if "to-root" in case else ".uevt")))
    got = {}
    for tag, main in (("port", port_main), ("jax", jax_main)):
        assert main(CASES[case](files, out)) == 0
        got[tag] = (open(out, "rb").read(), capsys.readouterr().out)
    assert got["port"] == got["jax"]
    assert got["port"][1].startswith("wrote ")
    if not out.endswith(".root"):
        r = EventFileReader(out)
        assert len(r) in (3, 4) and r.producers(0)


def test_inspect_prints_what_jax_prints(inputs, capsys):
    _, files = inputs
    assert port_main(["--inspect", files["root"]]) == 0
    port = capsys.readouterr().out
    assert jax_main(["--inspect", files["root"]]) == 0
    assert port == capsys.readouterr().out
    assert "image2d_wire_tree" in port and "decodes" in port


def test_output_required_without_inspect(inputs):
    _, files = inputs
    with pytest.raises(SystemExit):
        port_main([files["root"]])
