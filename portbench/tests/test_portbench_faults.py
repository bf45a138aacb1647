"""Each cell's comparison fails what it must, with the cell's own limits:

* on the CPU, at a small size and with the card's look skipped, a run of
  each cell with a fault planted under the timed path (lib/faults.py)
  comes out not correct: for scoring half of a batch left out and an
  answer altered, for training a step that leaves its state unchanged
  and half of a batch left out;
* on the card (marked ``cuda``), at the cell's own size, the control
  (kinds/*.py ``control``: the program's int8 path for scoring, the
  reference in float8 for training) comes out not correct.

    python -m pytest portbench/tests -q            # here
    python -m pytest portbench/tests -m cuda -q    # on the card
"""
import contextlib
import dataclasses
import json
import time

import pytest
import torch

from portbench.lib import common, faults, harness

SMALL = {"crop_hw": [64, 64], "batch": 4, "pool_crops": 8,
         "pool_batches": 4, "warmup_batches": 1, "warmup_steps": 0,
         "check_batches": 2}


def cells():
    b = json.loads((common.ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in b["workloads"]]


def small(name):
    cell = common.load_cell(name)
    return dataclasses.replace(cell, traffic=dict(cell.traffic, **SMALL))


def run(cell, fault=None, device="cpu", control=False, seconds=0.2):
    ctx = faults.planted(fault) if fault else contextlib.nullcontext()
    with ctx:
        return harness.run_cell(cell, 2 ** 31 + 11, seconds, False,
                                torch.device(device), time.perf_counter(),
                                control=control, say=lambda m: None)


@pytest.mark.parametrize("name", cells())
def test_faults_come_out_not_correct(name):
    cell = small(name)
    for fault in faults.FAULTS[cell.traffic["kind"]]:
        result = run(cell, fault)
        assert result["correct"] is False, (fault, result["checks"])
        assert list(result)[-1] == "checks"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run with -m cuda on the card")
    common.pin_caches()
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", cells())
def test_control_comes_out_not_correct(card, name):
    result = run(common.load_cell(name), device=card, control=True,
                 seconds=2.0)
    assert result["correct"] is False, result["checks"]
