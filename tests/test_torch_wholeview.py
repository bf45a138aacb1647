"""Wholeview deploy: the port's tiling geometry, split and stitch,
runner and CLI (ubresnet_tpu_torch.ops.tiling, deploy.wholeview,
cli.infer_wholeview, --device cpu) against the JAX package's on the
same seeded inputs and the same reference .tar.

The geometry must be equal, split and stitch within 1e-6 on random
float32 arrays, and the CLIs in float32 (spatial, the default, and
--stitched) must agree on the argmax of ≥ 99.9% of pixels with
max|Δp| ≤ 1e-3; each package reads the other's output. The int8 CLIs
are compared with each other and each with its own float32 output, at
the bar of tests/test_torch_int8_cli.py.

Two weight sets: the reference-format .tar of
tests/test_torch_precropped.py (make_state_dict, seed 7), and a "tame"
one — random_state_dict(seed=2) with the classifier scaled by 3e-4.
Random BatchNorm statistics blow the logits up (≈ 1e16 for the first,
≈ 6e3 for the second), which saturates every float32 probability to
exactly 0 or 1; the tame classifier keeps them informative (no pixel
at exactly 1), so probability differences mean something."""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ubresnet_tpu.cli.infer_wholeview import main as jax_main
from ubresnet_tpu.core.precision import Policy as JaxPolicy
from ubresnet_tpu.data.uevt import EventFileReader as JaxReader
from ubresnet_tpu.deploy import WholeViewRunner as JaxRunner
from ubresnet_tpu.deploy.importers import load_reference_model
from ubresnet_tpu.ops import tiling as jt
from ubresnet_tpu.parity.torch_oracle import make_state_dict
from ubresnet_tpu_torch.cli.infer_wholeview import main as port_main
from ubresnet_tpu_torch.cli.infer_wholeview import resolve_spatial
from ubresnet_tpu_torch.core.precision import Policy
from ubresnet_tpu_torch.data.meta import Image2D, ImageMeta
from ubresnet_tpu_torch.data.rootio import open_event_file
from ubresnet_tpu_torch.data.synthetic import make_synthetic_file
from ubresnet_tpu_torch.data.uevt import EventFileReader as PortReader
from ubresnet_tpu_torch.data.uevt import EventFileWriter
from ubresnet_tpu_torch.deploy import WholeViewRunner
from ubresnet_tpu_torch.deploy.weights import (
    load_reference_checkpoint,
    random_state_dict,
    save_reference_checkpoint,
)
from ubresnet_tpu_torch.models import get_model
from ubresnet_tpu_torch.ops import tiling as tt

torch.set_num_threads(1)
N, HW = 2, (128, 192)
TILES = ["--tile-rows", "64", "--tile-cols", "64", "--overlap-rows", "8",
         "--overlap-cols", "8", "--crop-batch", "4"]
TILE_KW = dict(tile_rows=64, tile_cols=64, min_overlap_rows=8,
               min_overlap_cols=8, crop_batch=4)


def tame_state_dict():
    sd = random_state_dict(seed=2)
    sd["conv11.weight"] = sd["conv11.weight"] * 3e-4
    return sd


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(dir, data, {weights name: .tar})."""
    d = tmp_path_factory.mktemp("wholeview")
    data = make_synthetic_file(str(d / "in.uevt"), n_events=N, hw=HW, seed=5)
    ckpts = {
        "reference": save_reference_checkpoint(
            make_state_dict(np.random.RandomState(7), inplanes=16),
            str(d / "ref.tar")),
        "tame": save_reference_checkpoint(tame_state_dict(),
                                          str(d / "tame.tar"))}
    return d, data, ckpts


@pytest.fixture(scope="module")
def port_f32(files):
    sd, _ = load_reference_checkpoint(files[2]["tame"])
    return get_model("uresnet", sd, policy=Policy.f32(), device="cpu")


# ---------------------------------------------------------------- geometry

GEOMETRY = [
    (1008, 3456, 512, 832, 16, 176),  # the reference's whole plane
    (128, 192, 64, 64, 8, 8),
    (100, 192, 64, 64, 0, 0),
    (512, 832, 512, 832, 16, 176),  # one tile
    (97, 301, 32, 48, 5, 31),
    (64, 1000, 64, 100, 0, 99),
]


@pytest.mark.parametrize("geom", GEOMETRY, ids=lambda g: "x".join(map(str, g)))
def test_geometry_equals_jax(geom):
    rows, cols, th, tw, orow, ocol = geom
    grid = tt.tile_grid(rows, cols, th, tw, orow, ocol)
    assert grid == jt.tile_grid(rows, cols, th, tw, orow, ocol)
    for size, tile, ov in ((rows, th, orow), (cols, tw, ocol)):
        assert tt._axis_positions(size, tile, ov) == jt._axis_positions(
            size, tile, ov)
    cov = tt.coverage(grid, th, tw, rows, cols)
    np.testing.assert_array_equal(cov, jt.coverage(grid, th, tw, rows, cols))
    assert cov.min() >= 1
    np.testing.assert_array_equal(
        tt.coverage_count(grid, th, tw, (rows, cols)).numpy()[..., 0], cov)
    rg = tt.random_grid(rows, cols, th, tw, n_tiles=7,
                        rng=np.random.RandomState(1))
    assert rg == jt.random_grid(rows, cols, th, tw, n_tiles=7,
                                rng=np.random.RandomState(1))
    img = np.random.RandomState(2).rand(rows, cols).astype(np.float32) * 12
    for frac in (0.0, 0.1, 0.2):
        assert (tt.filter_occupied(img, grid, th, tw, frac)
                == jt.filter_occupied(img, grid, th, tw, frac))


@pytest.mark.parametrize("tile,overlap", [(64, 64), (64, 176), (16, 20)])
def test_overlap_at_least_tile_raises_as_jax(tile, overlap):
    for mod in (tt, jt):
        with pytest.raises(ValueError, match="min_overlap"):
            mod.tile_grid(128, 192, tile, tile, min_overlap_rows=0,
                          min_overlap_cols=overlap)
        with pytest.raises(ValueError, match="larger than image"):
            mod.tile_grid(32, 32, 64, 64)


@pytest.mark.parametrize("args", [
    dict(),
    dict(rows=96, cols=256, tile_rows=32, tile_cols=64, covered_z_width=20,
         min_overlap_rows=8, half_height_cm=6.0),
    dict(rows=512, cols=2000, covered_z_width=200),
])
def test_detsplit_triplets_equal_jax(args):
    trips = tt.detsplit_triplets(**args)
    ref = jt.detsplit_triplets(**args)
    assert [dataclasses.astuple(t) for t in trips] == [
        dataclasses.astuple(t) for t in ref]
    tc = args.get("tile_cols", 832)
    hh = args.get("half_height_cm", tt.DET_HALF_HEIGHT_CM)
    for t in trips:
        assert tt.triplet_consistent(t, tile_cols=tc, half_height_cm=hh)
    for p in (0, 1, 2):
        assert tt.triplet_plane_grid(trips, p) == jt.triplet_plane_grid(ref, p)
    for plane in (0, 1, 2):
        for y, z in ((-100.0, 0.0), (3.0, 500.0), (116.5, 1036.8)):
            assert tt.wire_coordinate(plane, y, z) == jt.wire_coordinate(
                plane, y, z)
    with pytest.raises(ValueError, match="needs"):
        tt.detsplit_triplets(tile_cols=512)


@pytest.mark.parametrize("geom", [(100, 120, 32, 48, 8, 8),
                                  (128, 192, 64, 64, 8, 8),
                                  (96, 256, 32, 64, 8, 0)])
def test_extract_stitch_match_jax(geom):
    rows, cols, th, tw, orow, ocol = geom
    rng = np.random.RandomState(sum(geom))
    img = rng.rand(rows, cols, 3).astype(np.float32)
    grid = tt.tile_grid(rows, cols, th, tw, orow, ocol)
    tiles = tt.extract_tiles(torch.from_numpy(img), grid, th, tw)
    jtiles = np.asarray(jt.extract_tiles(jnp.asarray(img), grid, th, tw))
    np.testing.assert_array_equal(tiles.numpy(), jtiles)
    noisy = rng.rand(*jtiles.shape).astype(np.float32)
    got = tt.stitch_tiles(torch.from_numpy(noisy), grid, (rows, cols))
    want = np.asarray(jt.stitch_tiles(jnp.asarray(noisy), grid, (rows, cols)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # a cached count gives the same bits; identity tiles stitch back
    count = tt.coverage_count(grid, th, tw, (rows, cols))
    assert torch.equal(tt.stitch_tiles(torch.from_numpy(noisy), grid,
                                       (rows, cols), count), got)
    np.testing.assert_allclose(
        tt.stitch_tiles(tiles, grid, (rows, cols)).numpy(), img, rtol=1e-6)


def test_resolve_spatial_as_jax():
    from ubresnet_tpu.cli.infer_wholeview import resolve_spatial as jax_rs

    for spatial in (None, True, False):
        for stitched in (False, True):
            for detsplit in (False, True):
                args = (spatial, stitched, detsplit)
                if spatial and detsplit:
                    for fn in (resolve_spatial, jax_rs):
                        with pytest.raises(SystemExit, match="exclusive"):
                            fn(*args)
                    continue
                assert resolve_spatial(*args) == jax_rs(*args)
    assert resolve_spatial(None, False, False)  # spatial is the default


# ------------------------------------------------------------- the CLIs

def _planes(reader):
    """{entry: (scores (h, w, 3), score images)} of plane 2."""
    out = {}
    for i in range(len(reader)):
        imgs = reader.read_entry(i)["ubsnet_plane2"]
        out[i] = (np.stack([im.pixels.astype(np.float32) for im in imgs],
                           -1), imgs)
    return out


_RUNS = {}  # (CLI, weights, flags) → the output of that one run


def _run(main, files, name, *extra, device=True, weights="tame"):
    """The output file of ``main`` on the module's data with these
    weights and flags: one run per distinct invocation in the module
    (a CLI run is deterministic, so two tests asking for the same one
    read the same file)."""
    key = (main, weights, extra, device)
    if key not in _RUNS:
        d, data, ckpts = files
        out = str(d / f"{name}.uevt")
        argv = ["-i", data, "-o", out, "-c", ckpts[weights], *TILES, *extra]
        assert main(argv + (["--device", "cpu"] if device else [])) == 0
        _RUNS[key] = out
    return _RUNS[key]


@pytest.mark.parametrize("weights", ["reference", "tame"])
@pytest.mark.parametrize("mode", [[], ["--stitched"]],
                         ids=["spatial", "stitched"])
def test_port_cli_matches_jax_cli(files, mode, weights):
    tag = f"{weights}_{len(mode)}"
    out_port = _run(port_main, files, f"port_{tag}", "--f32", *mode,
                    weights=weights)
    out_jax = _run(jax_main, files, f"jax_{tag}", "--f32", *mode,
                   device=False, weights=weights)
    a, b = _planes(PortReader(out_jax)), _planes(JaxReader(out_port))
    src = PortReader(files[1])
    assert len(a) == len(b) == N
    dp, agree = 0.0, []
    for i in range(N):
        (sj, imgs_j), (sp, imgs_p) = a[i], b[i]
        assert len(imgs_j) == len(imgs_p) == 3
        assert sp.shape == sj.shape == HW + (3,)
        assert imgs_p[0].rse == src.rse(i) == imgs_j[0].rse
        meta = src.read_entry(i)["wire"][0].meta
        assert (dataclasses.astuple(imgs_p[0].meta)
                == dataclasses.astuple(imgs_j[0].meta)
                == dataclasses.astuple(meta))
        np.testing.assert_allclose(sp.sum(-1), 1.0, atol=1e-4)
        dp = max(dp, float(np.abs(sp - sj).max()))
        agree.append(sp.argmax(-1) == sj.argmax(-1))
    assert float(np.mean(agree)) >= 0.999
    assert dp <= 1e-3, dp


@pytest.mark.parametrize("mode", [[], ["--stitched"]],
                         ids=["spatial", "stitched"])
def test_port_cli_int8_tracks_its_f32_as_jax(files, capsys, monkeypatch,
                                             mode):
    """The port's int8 CLI against the JAX CLI's int8 on the same file
    and tame weights, and each against its own f32 scores, at the
    precropped int8 bar of tests/test_torch_int8_cli.py (mean|Δp| <
    0.02, argmax > 0.95); each package reads the other's int8 output.

    The JAX spatial run scores on one device. Row-sharded over the
    8 virtual CPU devices of the test environment, the JAX CLI's
    spatial int8 lands ≈ 0.08 mean|Δp| from its f32 and from its own
    one-device int8 (PERF.md §7), while its one-device int8 sits within
    the bar, as its stitched int8 and the port's int8 do. The port's
    row-sharded int8 is the one-device int8 bit for bit
    (tests/test_torch_spatial.py)."""
    import jax

    tag = "_".join(["q"] + [m.strip("-") for m in mode])
    port_q = _run(port_main, files, f"port_{tag}", "--int8",
                  "--int8-calib", "2", "-v", *mode)
    printed = capsys.readouterr().out
    assert "int8: calibrated on" in printed and "tiles" in printed
    assert json.loads(printed.strip().splitlines()[-1])["calibrate"] > 0
    all_devices = jax.devices
    with monkeypatch.context() as m:
        m.setattr(jax, "devices",
                  lambda *a, **k: all_devices(*a, **k)[:1])
        jax_q = _run(jax_main, files, f"jax_{tag}", "--int8",
                     "--int8-calib", "2", *mode, device=False)
    port_f = _run(port_main, files, f"port_f{tag}", "--f32", *mode)
    jax_f = _run(jax_main, files, f"jax_f{tag}", "--f32", *mode,
                 device=False)

    def scores(path, reader):
        return np.stack([s for s, _ in _planes(reader(path)).values()])

    sq, jq = scores(port_q, JaxReader), scores(jax_q, PortReader)
    sf, jf = scores(port_f, PortReader), scores(jax_f, PortReader)
    assert sq.shape == jq.shape == (N,) + HW + (3,)
    dist = {}
    for name, q, f in (("port-f32", sq, sf), ("jax-f32", jq, jf),
                       ("port-jax", sq, jq)):
        assert np.isfinite(q).all()
        np.testing.assert_allclose(q.sum(-1), 1.0, atol=1e-2)
        dist[name] = (float(np.abs(q - f).mean()),
                      float((q.argmax(-1) == f.argmax(-1)).mean()))
    print("int8 mean|dp|, argmax agreement:", tag, dist)
    for name in ("port-f32", "jax-f32", "port-jax"):
        mean, agree = dist[name]
        assert mean < 0.02 and agree > 0.95, (name, dist)


def test_cli_refuses_what_is_not_ported(files):
    d, data, ckpts = files
    ckpt = ckpts["tame"]
    base = ["-i", data, "-c", ckpt, "--device", "cpu"]
    # larcv .root output is ported: float32 scores whatever --f16-scores
    assert port_main(base + ["-o", str(d / "x.root"), *TILES,
                             "--f16-scores"]) == 0
    img = open_event_file(str(d / "x.root")).read_entry(0)[
        "ubsnet_plane2"][0]
    assert img.pixels.dtype == np.float32 and img.pixels.shape == HW
    # --arch aspp_resnet: a UResNet .tar exits naming the missing keys,
    # an ASPP .tar scores
    with pytest.raises(SystemExit, match="ASPP_layer_enc3"):
        port_main(base + ["-o", str(d / "x.uevt"), "--arch", "aspp_resnet"])
    aspp = save_reference_checkpoint(
        random_state_dict(seed=2, arch="aspp_resnet"), str(d / "aspp.tar"))
    assert port_main(["-i", data, "-c", aspp, "--device", "cpu", "-o",
                      str(d / "aspp.uevt"), "--arch", "aspp_resnet",
                      *TILES]) == 0
    scores = _planes(PortReader(str(d / "aspp.uevt")))
    assert len(scores) == N and all(s.shape == HW + (3,)
                                    for s, _ in scores.values())
    for s, _ in scores.values():
        np.testing.assert_allclose(s.sum(-1), 1.0, atol=1e-2)
    with pytest.raises(SystemExit, match="checkpoint directory"):
        port_main(base + ["-o", str(d / "x.uevt"), "--config", "c.json"])
    with pytest.raises(SystemExit, match="exclusive"):
        port_main(base + ["-o", str(d / "x.uevt"), "--spatial", "--detsplit"])
    with pytest.raises(SystemExit, match="exclusive"):
        port_main(base + ["-o", str(d / "x.uevt"), "--int8", "--f32"])


# ------------------------------------------------------------- the runner

def test_detsplit_passthrough_matches_jax(tmp_path, files, port_f32):
    """Three planes of a scaled detector view (half height 6 cm, so a
    64-column tile spans y and a 20-pixel z window): both runners score
    each plane with its triplet grid and copy the input through."""
    rows, cols, hh = 96, 256, 6.0
    rng = np.random.RandomState(0)
    path = str(tmp_path / "whole.uevt")
    with EventFileWriter(path) as w:
        for plane in (0, 1, 2):
            img = (rng.rand(rows, cols) * 50).astype(np.float32)
            img[img < 40] = 0.0
            meta = ImageMeta(0.0, 0.0, float(cols), float(rows), rows, cols,
                             plane)
            w.append("wire", Image2D(img, meta, 1, 0, 7))
        w.set_id(1, 0, 7)
        w.save_entry()
    kw = dict(tile_rows=32, tile_cols=64, min_overlap_rows=8, crop_batch=4,
              covered_z_width=20, det_half_height_cm=hh)
    out_p, out_j = str(tmp_path / "p.uevt"), str(tmp_path / "j.uevt")
    WholeViewRunner(port_f32, **kw).run(path, out_p, detsplit=True,
                                        passthrough=True)
    jm, jv = load_reference_model(files[2]["tame"], policy=JaxPolicy.f32())
    JaxRunner(jm, jv, **kw).run(path, out_j, detsplit=True, passthrough=True)
    evp, evj = JaxReader(out_p).read_entry(0), PortReader(out_j).read_entry(0)
    assert sorted(evp) == sorted(evj) == [
        "ubsnet_plane0", "ubsnet_plane1", "ubsnet_plane2", "wire"]
    src = PortReader(path).read_entry(0)["wire"]
    for a, b in zip(evp["wire"], src):
        np.testing.assert_array_equal(a.pixels, b.pixels)
    trips = tt.detsplit_triplets(rows, cols, 32, 64, covered_z_width=20,
                                 min_overlap_rows=8, half_height_cm=hh)
    for plane in (0, 1, 2):
        sp = np.stack([s.pixels for s in evp[f"ubsnet_plane{plane}"]], -1)
        sj = np.stack([s.pixels for s in evj[f"ubsnet_plane{plane}"]], -1)
        cov = tt.coverage(tt.triplet_plane_grid(trips, plane), 32, 64,
                          rows, cols)
        np.testing.assert_allclose(sp.sum(-1)[cov >= 1], 1.0, atol=1e-4)
        assert (sp.sum(-1)[cov == 0] == 0).all()
        assert np.abs(sp - sj).max() <= 1e-4
        assert (sp.argmax(-1) == sj.argmax(-1)).mean() >= 0.999


def test_calibrate_from_raises_without_occupied_tiles(tmp_path, files):
    sd, _ = load_reference_checkpoint(files[2]["tame"])
    model = get_model("uresnet", sd, policy=Policy.int8(), device="cpu")
    path = str(tmp_path / "empty.uevt")
    with EventFileWriter(path) as w:
        meta = ImageMeta(0.0, 0.0, 192.0, 128.0, rows=128, cols=192, plane=2)
        px = np.zeros(HW, np.float32)
        px[5, 5] = 9.0  # below the 10-ADC occupancy threshold
        w.append("wire", Image2D(px, meta, 1, 0, 0))
        w.set_id(1, 0, 0)
        w.save_entry()
    runner = WholeViewRunner(model, **TILE_KW)
    with pytest.raises(ValueError, match="occupied"):
        runner.calibrate_from(path)


@pytest.mark.parametrize("spatial", [False, True])
def test_score_image_of_one_tile_is_a_forward(port_f32, spatial):
    """An image the size of one tile: the stitched path is one crop
    averaged once, the spatial path one unpadded forward — both equal a
    plain forward."""
    img = np.random.RandomState(0).rand(64, 64).astype(np.float32) * 5
    img[img < 3] = 0.0
    runner = WholeViewRunner(port_f32, tile_rows=64, tile_cols=64,
                             crop_batch=1, spatial=spatial)
    got = runner.score_image(img)
    with torch.inference_mode():
        ref = torch.exp(port_f32(torch.from_numpy(img)[None, ..., None]))[0]
    np.testing.assert_allclose(got, ref.numpy(), rtol=1e-4, atol=1e-5)


def test_spatial_pads_as_jax(port_f32, files):
    """A plane whose sides are no multiple of 32: the spatial runner
    pads the high side, scores once and slices back — JAX's geometry,
    so the bottom rows match the JAX runner's unsharded forward."""
    img = np.random.RandomState(3).rand(100, 176).astype(np.float32) * 5
    img[img < 4.0] = 0.0
    got = WholeViewRunner(port_f32, spatial=True).score_image(img)
    assert got.shape == (100, 176, 3)
    jm, jv = load_reference_model(files[2]["tame"], policy=JaxPolicy.f32())
    pad = jnp.pad(jnp.asarray(img), ((0, 28), (0, 16)))[None, ..., None]
    ref = np.asarray(jnp.exp(jax.jit(jm.apply)(jv, pad))[0, :100, :176, :])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    assert (got.argmax(-1) == ref.argmax(-1)).mean() >= 0.999


def test_dense_transfer_and_capacity_only_grow(port_f32):
    """sparse=False ships the dense plane; the sparse capacity grows to
    the largest plane and is kept (pad slots are no-ops): the scores of
    a sparse plane after a denser one equal its first scoring."""
    rng = np.random.RandomState(4)
    dense = (rng.rand(64, 128) * 20).astype(np.float32)
    light = dense.copy()
    light[rng.rand(64, 128) > 0.02] = 0.0
    kw = dict(tile_rows=64, tile_cols=64, min_overlap_cols=8, crop_batch=2,
              sparse_bucket=64)
    sparse = WholeViewRunner(port_f32, **kw)
    first = sparse.score_image(light)
    cap_light = sparse._cap
    sparse.score_image(dense)
    cap = sparse._cap
    assert cap > cap_light
    np.testing.assert_array_equal(sparse.score_image(light), first)
    assert sparse._cap == cap
    np.testing.assert_array_equal(
        WholeViewRunner(port_f32, sparse=False, **kw).score_image(light),
        first)


def test_cli_defaults_to_cuda(monkeypatch, files):
    """No --device: the wholeview CLI asks for the card and raises
    without one."""
    d, data, ckpts = files
    ckpt = ckpts["tame"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(["-i", data, "-o", str(d / "nocard.uevt"), "-c", ckpt])
