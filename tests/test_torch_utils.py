"""The port's utilities against the JAX package's: utils/png.py writes the
same PNG bytes for the same values, and utils/profiling.py's StageTimer
keeps and reports cumulative stage times in the same form (``sync``
waits only for a CUDA result; on the CPU there is nothing to wait
for)."""
import numpy as np
import pytest
import torch

from ubresnet_tpu.utils import png as jax_png
from ubresnet_tpu.utils.profiling import StageTimer as JaxStageTimer
from ubresnet_tpu_torch.utils import png
from ubresnet_tpu_torch.utils.profiling import StageTimer

torch.set_num_threads(1)


@pytest.mark.parametrize("limits", [(None, None), (0, 2), (5.0, 5.0)],
                         ids=["auto", "labels", "flat"])
def test_heatmap_bytes_equal_jax(tmp_path, limits):
    rng = np.random.RandomState(3)
    values = (rng.rand(17, 23) * 40).astype(np.float32)
    values[3:6, 4:9] = 0.0
    got, want = tmp_path / "p.png", tmp_path / "j.png"
    png.save_heatmap(str(got), values, *limits)
    jax_png.save_heatmap(str(want), values, *limits)
    assert got.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert got.read_bytes() == want.read_bytes()
    np.testing.assert_array_equal(png.colormap(values, *limits),
                                  jax_png.colormap(values, *limits))


def test_stage_timer_reports_as_jax():
    port, jax = StageTimer(), JaxStageTimer()
    x = torch.ones(3)
    for timer in (port, jax):
        for name in ("read", "forward", "read"):
            with timer.stage(name):
                pass
    with port.stage("forward", result=x, sync=True):  # CPU: no wait
        x = x + 1
    assert port.counts == {"read": 2, "forward": 2}
    assert list(port.as_dict()) == list(jax.as_dict()) == ["read",
                                                           "forward"]
    port.times.update(read=1.5, forward=0.25)
    jax.times.update(read=1.5, forward=0.25)
    assert port.report(10) == jax.report(10)
    assert port.report() == jax.report()
