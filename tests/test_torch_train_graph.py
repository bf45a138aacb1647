"""The train step as CUDA graphs (train/step.py).

On the CPU: which steps take the graph path (``graph_eligible``),
densify into fixed buffers against ``densify_batch``, and the CPU step
staying eager. Marked ``cuda`` (each skips without an NVIDIA card), on
the card at 64x64:
    python -m pytest tests/test_torch_train_graph.py -m cuda -q
a graphed run of six steps against the same steps run eagerly
(``step.eager`` with the update the graphs capture): losses, parameters,
BN running stats, the optimizer's state and count and the skips agree
within the spread of two eager runs, exactly where that spread is 0;
a non-finite batch under the graph changes nothing; a schedule that
moves lr every step, a second batch size, ``accum_steps`` 2, SGD,
QAT at abs-max and remat run graphed.
"""
import dataclasses

import numpy as np
import pytest
import torch

from ubresnet_tpu_torch import ops
from ubresnet_tpu_torch.core.mesh import Mesh
from ubresnet_tpu_torch.core.precision import Policy
from ubresnet_tpu_torch.deploy.weights import random_state_dict
from ubresnet_tpu_torch.models import get_model
from ubresnet_tpu_torch.ops.sparse import densify_batch, sparsify_batch
from ubresnet_tpu_torch.train import (
    build_train_step,
    create_train_state,
    make_optimizer,
)
from ubresnet_tpu_torch.train.step import graph_eligible

HW = 64
# one b4 64x64 step's kernel launches (tests/test_torch_cuda.py)
STEP_LAUNCHES = {"conv_bn_act": 18, "maxpool3x3s2": 1, "conv_stats": 16,
                 "conv_dw": 17, "weighted_nll": 1, "weighted_nll_bwd": 1}


def _batch(rng, b=4, occupancy=0.05):
    """A sparse train batch: charge on a share of the pixels, labelled
    1 or 2 there, weighted 1 elsewhere and 2-10 on the charge."""
    hit = rng.rand(b, HW, HW) < occupancy
    image = np.where(hit, rng.rand(b, HW, HW) * 50 + 1, 0).astype(np.float32)
    label = np.where(hit, rng.randint(1, 3, (b, HW, HW)), 0).astype(np.int32)
    weight = np.where(hit, rng.rand(b, HW, HW) * 8 + 2, 1).astype(np.float32)
    sp = sparsify_batch({"image": image[..., None], "label": label,
                         "weight": weight}, bucket=64)
    sp.pop("hw")
    return sp


def _batches(seed, n=6, sizes=(4,)):
    rng = np.random.RandomState(seed)
    return [_batch(rng, sizes[i % len(sizes)], 0.02 + 0.03 * (i % 3))
            for i in range(n)]


# ---------------------------------------------------------------- the CPU


@pytest.fixture(scope="module")
def models():
    sd = random_state_dict(seed=1)

    def build(**policy):
        return get_model("uresnet", sd, device="cpu", train=True,
                         policy=dataclasses.replace(Policy(), **policy))

    return {"plain": build(),
            "qat_pct": build(quant_train=True, quant_percentile=99.9),
            "qat_absmax": build(quant_train=True),
            "stage_remat": build(remat=True)}


@pytest.mark.parametrize("case, model, device, mesh, want", [
    ("card", "plain", "cuda", None, True),
    ("cpu", "plain", "cpu", None, False),
    ("one-process mesh", "plain", "cuda", Mesh(), True),
    ("mesh with a group", "plain", "cuda", Mesh(2, 0, object()), False),
    ("qat percentile", "qat_pct", "cuda", None, False),
    ("qat abs-max", "qat_absmax", "cuda", None, True),
    ("qat percentile on the cpu", "qat_pct", "cpu", None, False),
    ("stage remat", "stage_remat", "cuda", None, True),
])
def test_graph_eligible(models, case, model, device, mesh, want):
    """The graph path engages on the card with no process group and no
    QAT activation quantizer with a percentile."""
    assert graph_eligible(models[model], torch.device(device),
                          mesh) is want, case


def test_densify_into_buffers_matches_densify_batch():
    """densify_batch into fixed buffers (garbage in them, two batches
    of different COO widths in turn) gives densify_batch's tensors
    exactly, in those buffers."""
    rng = np.random.RandomState(3)
    first = _batch(rng, occupancy=0.02)
    second = _batch(rng, occupancy=0.08)
    assert first["img_idx"].shape[1] != second["img_idx"].shape[1]
    out = {"image": torch.full((4, HW, HW, 1), 7.0),
           "label": torch.full((4, HW, HW), 5, dtype=torch.int32),
           "weight": torch.full((4, HW, HW), -3.0)}
    ptrs = {k: v.data_ptr() for k, v in out.items()}
    for sp in (first, second):
        sp = {k: torch.from_numpy(v) for k, v in sp.items()}
        want = densify_batch(sp, (HW, HW))
        got = densify_batch(sp, (HW, HW), out)
        for k in want:
            assert got[k].data_ptr() == ptrs[k], k
            assert got[k].dtype == want[k].dtype, k
            assert torch.equal(got[k], want[k]), k


def test_cpu_step_stays_eager():
    """A CPU step never builds graphs: graph_steps stays 0."""
    model = get_model("uresnet", random_state_dict(seed=4), device="cpu",
                      train=True, policy=Policy.f32())
    opt = make_optimizer(model.parameters(), "adam", 1e-3)
    step = build_train_step(sparse_hw=(HW, HW), device="cpu")
    state = create_train_state(model, opt)
    for sp in _batches(5, n=2, sizes=(2,)):
        state, m = step(state, sp)
    assert np.isfinite(m["loss"]) and m["nan_skipped"] == 0
    assert state.graph_steps == 0 and step.graphs is None
    assert opt.lr is None and state.step == 2


# --------------------------------------------------------------- the card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run with -m cuda on the card")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _train(dev, batches, graphed, *, name="adam", lr=1e-3, accum=1,
           policy=None, remat=False, seed=6):
    """Steps over ``batches`` from seeded weights → (state, step,
    losses). ``graphed`` False: ``step.eager`` with the optimizer made
    capturable first, so both paths run the same update."""
    policy = policy or Policy()
    model = get_model("uresnet", random_state_dict(seed=seed), device=dev,
                      train=True, policy=policy)
    opt = make_optimizer(model.parameters(), name, lr, weight_decay=1e-4)
    step = build_train_step(use_pallas_loss=policy.fused_train,
                            sparse_hw=(HW, HW), accum_steps=accum,
                            remat=remat, device=dev)
    state = create_train_state(model, opt)
    if not graphed:
        opt.capturable()
    losses = []
    for sp in batches:
        state, m = (step if graphed else step.eager)(state, sp)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    return state, step, losses


def _snapshot(state, losses):
    model, opt = state.model, state.optimizer
    out = {"losses": torch.tensor(losses, dtype=torch.float64),
           "count": torch.tensor(float(opt.count)),
           "nan_count": torch.tensor(float(state.nan_count))}
    for k, v in model.named_parameters():
        out["param " + k] = v.detach().float().cpu()
    for k, v in model.named_buffers():
        out["buffer " + k] = v.detach().float().cpu()
    for i, p in enumerate(model.parameters()):
        for k, v in opt.opt.state.get(p, {}).items():
            out[f"optimizer {i} {k}"] = v.detach().float().cpu()
    return out


def _agree(dev, batches, **kw):
    """The graphed run against two eager runs: every quantity within
    4x its eager spread, exactly where the spread is 0. Returns the
    graphed (state, step)."""
    e1, e2 = (_snapshot(*_train(dev, batches, False, **kw)[::2])
              for _ in range(2))
    state, step, losses = _train(dev, batches, True, **kw)
    g = _snapshot(state, losses)
    assert set(g) == set(e1) == set(e2)
    for k in e1:
        spread = float((e1[k] - e2[k]).abs().max())
        for e in (e1, e2):
            gap = float((g[k] - e[k]).abs().max())
            assert gap <= 4 * spread, (k, gap, spread)
    return state, step


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_graph_step_matches_eager(dev, name):
    """Six batches of one shape whose COO widths differ: one eager
    step, five replays of one graph, and the eager run's numbers; the
    launch counters count every replay's kernels; the optimizer's
    state_dict is an uncaptured one's."""
    batches = _batches(7)
    assert len({sp["img_idx"].shape[1] for sp in batches}) > 1
    state, step = _agree(dev, batches, name=name)
    assert state.graph_steps == 5 and state.nan_count == 0
    assert len(step.graphs.graphs) == 1
    sd = state.optimizer.state_dict()["torch"]
    for group in sd["param_groups"]:
        assert isinstance(group["lr"], float)
        assert not group.get("capturable", False)
    assert all(not t.is_cuda for s in sd["state"].values()
               for t in s.values() if t.dim() == 0)
    ops.reset_launch_counts()
    for sp in batches[:3]:
        state, _ = step(state, sp)
    assert state.graph_steps == 8
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    assert counts == {k: 3 * v for k, v in STEP_LAUNCHES.items()}


@pytest.mark.cuda
def test_graph_step_skips_non_finite(dev):
    """A NaN batch replayed: parameters, the optimizer's state and
    count and the BN running stats stay as they were; the skip counts,
    and the next batch updates."""
    batches = _batches(8, n=3)
    state, step, _ = _train(dev, batches[:2], True)
    model, opt = state.model, state.optimizer
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt_before = {i: {k: v.clone() for k, v in s.items()}
                  for i, s in opt.opt.state_dict()["state"].items()}
    count = opt.count
    bad = {k: v.copy() for k, v in batches[2].items()}
    bad["img_val"][1, 0] = np.nan
    state, m = step(state, bad)
    assert m["nan_skipped"] == 1 and state.nan_count == 1
    assert not np.isfinite(m["loss"]) and state.graph_steps == 2
    assert opt.count == count
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for i, s in opt.opt.state_dict()["state"].items():
        for k, v in s.items():
            assert torch.equal(v, opt_before[i][k]), (i, k)
    state, m = step(state, batches[2])
    assert np.isfinite(m["loss"]) and opt.count == count + 1
    assert not torch.equal(model.conv10.weight, before["conv10.weight"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_graph_step_follows_the_schedule(dev, name):
    """An lr that changes every update: the replays run each at its
    own, as the eager steps do."""
    state, _ = _agree(dev, _batches(9), name=name,
                      lr=lambda k: 1e-3 * 0.7 ** k)
    if name == "adam":
        assert float(state.optimizer.lr) == pytest.approx(
            1e-3 * 0.7 ** (state.optimizer.count - 1), rel=1e-6)


@pytest.mark.cuda
def test_graph_step_second_batch_size(dev):
    """Batches of 4 and 2 in turn: a graph each, one set of gradients,
    the eager numbers."""
    state, step = _agree(dev, _batches(10, n=7, sizes=(4, 2)))
    assert len(step.graphs.graphs) == 2 and state.graph_steps == 5


@pytest.mark.cuda
def test_graph_step_accum(dev):
    """accum_steps 2 runs graphed, with the eager numbers."""
    state, _ = _agree(dev, _batches(11), accum=2)
    assert state.graph_steps == 5


@pytest.mark.cuda
def test_graph_step_qat_absmax(dev):
    """QAT with abs-max activation scales runs graphed, with the eager
    numbers."""
    state, _ = _agree(dev, _batches(12, n=4),
                      policy=dataclasses.replace(Policy(), quant_train=True))
    assert state.graph_steps == 3


@pytest.mark.cuda
@pytest.mark.parametrize("whole", [True, False])
def test_graph_step_remat(dev, whole):
    """Remat, the step's whole forward or the model's stages, captures:
    the eager numbers."""
    policy = dataclasses.replace(Policy(), remat=not whole)
    state, _ = _agree(dev, _batches(14, n=4), remat=whole, policy=policy)
    assert state.graph_steps == 3


@pytest.mark.cuda
def test_capturable_adam_is_the_eager_update(dev):
    """The update the graphs capture (Adam fused and capturable, lr a
    card tensor) is Adam's: on the same gradients, three updates at a
    moving lr land within float32 rounding of the uncaptured foreach
    Adam's."""
    g = torch.Generator().manual_seed(15)
    shapes = [(7, 7, 1, 16), (16,), (3, 3, 64, 32), (32,)]
    start = [torch.randn(*s, generator=g) for s in shapes]
    runs = []
    for captured in (False, True):
        params = [torch.nn.Parameter(t.to(dev)) for t in start]
        opt = make_optimizer(params, "adam", lambda k: 1e-3 * 0.5 ** k,
                             weight_decay=1e-4)
        if captured:
            opt.capturable()
        gg = torch.Generator().manual_seed(16)
        for _ in range(3):
            for p in params:
                p.grad = (torch.randn(*p.shape, generator=gg)
                          * 10.0 ** torch.randint(-6, 1, (), generator=gg)
                          ).to(dev)
            opt.step()
        runs.append([p.detach().cpu() for p in params])
    for want, got in zip(*runs):
        err = float((want - got).abs().max())
        assert err <= 1e-6, err  # a thousandth of one update's 1e-3
