"""The frozen work table (portbench/work) against the bound column of
the port's kernel table (PERF.md §6, from chip_smoke.py's arithmetic):
the flagship at b16 512², the inplanes-32 UResNet's rows."""
import json

import pytest

from portbench.lib.common import BENCH_DIR
from portbench.work import arith


def work(name):
    with open(BENCH_DIR / "work" / f"{name}.json") as f:
        return json.load(f)


def rows_by_layer(rows):
    return {r["layer"]: r for r in rows}


def test_flagship_eval_bounds():
    rows = rows_by_layer(arith.eval_rows(work("uresnet16")["eval"], 16,
                                         (512, 512)))
    head = rows["head conv10"]
    assert head["by"] == "ops" and round(head["bound_s"] * 1e3, 3) == 0.106
    k3 = [rows["dec2.deconv"], rows["dec1.deconv"]]
    assert all(r["by"] == "bytes" for r in k3)
    assert round(sum(r["bound_s"] for r in k3) * 1e3, 3) == 0.090
    assert round(rows["classifier conv11"]["bound_s"] * 1e3, 3) == 0.048
    assert round(rows["stem pool"]["bound_s"] * 1e3, 3) == 0.050
    single = ["enc1.res1", "enc1.res2", "dec2.res.res2", "dec1.res.res2"]
    assert round(sum(rows[k]["bound_s"] for k in single) * 1e3, 3) == 0.191
    dual = ["dec2.res.res1", "dec1.res.res1"]
    assert round(sum(rows[k]["bound_s"] for k in dual) * 1e3, 3) == 0.183


@pytest.mark.parametrize("name,hw,want", [
    ("uresnet16", (512, 512), {"conv_stats": (16, 1.008),
                               "conv_bn_act": (18, 1.103),
                               "conv_dw": (17, 1.056),
                               "weighted_nll": (2, 0.065),
                               "maxpool3x3s2": (1, 0.050)}),
    ("uresnet32", (256, 256), {"conv_stats": (14, 0.421),
                               "conv_bn_act": (16, 0.433 + 0.012),
                               "conv_dw": (15, 0.433),
                               "maxpool3x3s2": (1, 0.025)}),
])
def test_train_step_bounds(name, hw, want):
    by = arith.by_kernel(arith.train_rows(work(name)["train"], 16, hw, 3))
    for kernel, (launches, ms) in want.items():
        assert by[kernel]["launches"] == launches, kernel
        assert abs(by[kernel]["bound_s"] * 1e3 - ms) <= 0.0015, kernel


def test_inplanes32_eval_bounds():
    rows = rows_by_layer(arith.eval_rows(work("uresnet32")["eval"], 16,
                                         (512, 512)))
    for layer in ("dec2.res.res1", "dec1.res.res1"):
        assert round(rows[layer]["bound_s"] * 1e3, 3) == 0.252
    assert round(rows["dec1.deconv"]["bound_s"] * 1e3, 3) == 0.120
    by = arith.by_kernel(arith.eval_rows(work("uresnet32")["eval"], 16,
                                         (512, 512)))
    assert {k: v["launches"] for k, v in by.items()} == {
        "maxpool3x3s2": 1, "basic_block": 6, "deconv2x": 1,
        "conv_bn_act": 1}


@pytest.mark.parametrize("name,hw,macs", [
    ("uresnet16", (512, 512), 33_302_773_760),
    ("uresnet32", (512, 512), 124_373_696_512),
    ("uresnet32", (256, 256), 31_093_424_128),
])
def test_model_flops(name, hw, macs):
    # every conv and transposed conv of one crop's forward, as counted
    # before the reference was looked up by the configuration's ``arch``
    cfg = json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())
    assert arith.forward_macs(cfg, hw) == macs
    # the head alone: two 7x7 convs at full resolution
    assert macs > hw[0] * hw[1] * 49 * (16 * cfg["inplanes"] + 16 * 3)
