"""The port's larcv ROOT I/O (ubresnet_tpu_torch/data/rootio.py over its
own copy of cpp/rootio.cpp) against the JAX package's, on the files
tests/root_synth.py writes from a seed.

  * every layout and codec of tests/test_rootio.py decodes to the same
    pixels, meta and run/subrun/event in both packages (and to the
    synthesizer's truth);
  * the port's RootWriter, compressed or not, writes the same bytes as
    JAX's for the same images to the same path (the TFile record holds
    the path it was created at), and tests/rootwalk.py (a decoder that
    shares no code with either) reads them;
  * uevt_to_root and root_to_uevt write the same bytes as JAX's;
  * inspect_file and the readers' errors say the same;
  * seeded mutations of a file never take the reading process down."""
import itertools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import rootwalk
from root_synth import write_larcv_like
from ubresnet_tpu.data import rootio as jax_rootio
from ubresnet_tpu.data.meta import Image2D as JaxImage2D
from ubresnet_tpu.data.meta import ImageMeta as JaxImageMeta
from ubresnet_tpu_torch.data import rootio
from ubresnet_tpu_torch.data.meta import Image2D, ImageMeta
from ubresnet_tpu_torch.data.synthetic import make_synthetic_file

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LAYOUTS = (
    [dict(int_width=w, img_first=f, nested_point=n, tobject_base=t)
     for w, f, n, t in itertools.product([8, 4], [True, False],
                                         [True, False], [True, False])]
    + [dict(compression=c) for c in ("none", "zlib", "zstd", "lz4", "lzma")]
    + [dict(rows=64, cols=48, frame_size=2048)]
    + [dict(memberwise=True, img_first=f) for f in (True, False)]
    + [dict(split=True, memberwise=m) for m in (False, True)]
    + [dict(split=True, int_width=4)]
)


def _layout_id(kw):
    return "-".join(f"{k}={v}" for k, v in kw.items())


def _events(mod, path):
    """{(tree, branch, entry): (rse, [(pixels, meta tuple, rse)])} as a
    package's RootFile decodes every entry of every image2d tree."""
    out = {}
    with mod.RootFile(path) as rf:
        for prod, (tree, branch, n) in mod.image2d_trees(rf).items():
            for e in range(n):
                rse, imgs = rf.read_event(tree, branch, e)
                out[(tree, branch, e)] = (rse, [
                    (im.pixels, (im.meta.min_x, im.meta.min_y, im.meta.max_x,
                                 im.meta.max_y, im.meta.rows, im.meta.cols,
                                 im.meta.plane), im.rse) for im in imgs])
    return out


@pytest.mark.parametrize("kw", LAYOUTS, ids=_layout_id)
def test_reader_decodes_like_jax(tmp_path, kw):
    path = str(tmp_path / "a.root")
    planes = (0, 1, 2) if kw.get("memberwise") else (1, 2)
    truth = write_larcv_like(path, producers=("wire", "segment"),
                             n_entries=3, planes=planes, **kw)
    got, want = _events(rootio, path), _events(jax_rootio, path)
    assert got.keys() == want.keys() and len(got) == 6
    for key, (rse, imgs) in want.items():
        g_rse, g_imgs = got[key]
        assert g_rse == rse and len(g_imgs) == len(imgs) == len(planes)
        for (gp, gm, gr), (wp, wm, wr) in zip(g_imgs, imgs):
            assert gp.dtype == np.float32
            np.testing.assert_array_equal(gp, wp)
            assert gm == wm and gr == wr
    for prod, entries in truth.items():
        tree, branch = f"image2d_{prod}_tree", f"image2d_{prod}_branch"
        for e, (arrs, metas, rse) in enumerate(entries):
            g_rse, g_imgs = got[(tree, branch, e)]
            assert g_rse == rse
            for (gp, gm, _), arr, m in zip(g_imgs, arrs, metas):
                np.testing.assert_array_equal(gp, arr)
                assert gm[6] == m["plane"] and gm[3] == pytest.approx(m["oy"])
    # the event-reader view the deploy paths use
    with rootio.open_event_file(path) as r, \
            jax_rootio.open_event_file(path) as jr:
        assert type(r).__name__ == "RootEventReader"
        assert (len(r), r.producers()) == (len(jr), jr.producers())
        for e in range(len(r)):
            assert r.rse(e) == jr.rse(e)
            ge, we = r.read_entry(e, ["wire"]), jr.read_entry(e, ["wire"])
            assert list(ge) == list(we) == ["wire"]
            for a, b in zip(ge["wire"], we["wire"]):
                np.testing.assert_array_equal(a.pixels, b.pixels)


def _write(mod, img_cls, meta_cls, path, compress, entries_per_basket=2):
    """Five entries, two producers, images of varying shapes, from a
    seed; returns the truth {(producer, entry, plane): (pixels, meta)}."""
    rng = np.random.RandomState(11)
    truth = {}
    with mod.RootWriter(path, compress=compress,
                        entries_per_basket=entries_per_basket) as w:
        for e in range(5):
            for prod, nplanes in (("uburn_plane0", 3), ("wire", 1)):
                for p in range(nplanes):
                    px = rng.rand(16 + e, 12 + p).astype(np.float32)
                    meta = meta_cls(2.0 * p, -3.0, 2.0 * p + (12 + p) * 0.5,
                                    -3.0 + (16 + e) * 0.5, 16 + e, 12 + p, p)
                    w.append(prod, img_cls(px, meta))
                    truth[(prod, e, p)] = px
            w.set_id(7, 2, 900 + e)
            w.save_entry()
    return truth


@pytest.mark.parametrize("compress", [True, False])
def test_writer_bytes_equal_jax_and_walk(tmp_path, compress):
    path = str(tmp_path / "w.root")
    _write(jax_rootio, JaxImage2D, JaxImageMeta, path, compress)
    want = open(path, "rb").read()
    truth = _write(rootio, Image2D, ImageMeta, path, compress)
    assert open(path, "rb").read() == want
    res = rootwalk.walk_file(path)
    for prod, nplanes in (("uburn_plane0", 3), ("wire", 1)):
        tree = res["trees"][f"image2d_{prod}_tree"]
        assert tree["entries"] == 5
        for e, ev in enumerate(tree["events"]):
            assert (ev.run, ev.subrun, ev.event) == (7, 2, 900 + e)
            for p, img in enumerate(ev.images):
                np.testing.assert_array_equal(
                    np.array(img.pixels, np.float32), truth[(prod, e, p)])


def test_conversions_bytes_equal_jax(tmp_path):
    """uevt_to_root and root_to_uevt (with and without a producer
    selection) write what JAX's write, to the same paths."""
    src = make_synthetic_file(str(tmp_path / "s.uevt"), n_events=3,
                              hw=(32, 48), seed=4)
    root, back, sel = (str(tmp_path / n) for n in ("c.root", "c.uevt",
                                                    "c_sel.uevt"))
    outs = {}
    for mod in (rootio, jax_rootio):
        assert mod.uevt_to_root(src, root) == 3
        assert mod.root_to_uevt(root, back) == 3
        assert mod.root_to_uevt(root, sel, ["wire"]) == 3
        outs[mod] = [open(p, "rb").read() for p in (root, back, sel)]
    assert outs[rootio] == outs[jax_rootio]


def test_inspect_and_errors_match_jax(tmp_path):
    path = str(tmp_path / "a.root")
    write_larcv_like(path, producers=("wire",), n_entries=2,
                     compression="zstd")
    assert rootio.inspect_file(path) == jax_rootio.inspect_file(path)

    def error(mod, fn):
        with pytest.raises(IOError) as e:
            fn(mod)
        return str(e.value)

    cases = [
        lambda m: m.RootFile(path).read_raw("image2d_wire_tree", "nope", 0),
        lambda m: m.RootFile(path).read_event("image2d_wire_tree",
                                              "image2d_wire_branch", 99),
        lambda m: m.root_to_uevt(path, str(tmp_path / "x.uevt"), ["segment"]),
    ]
    for fn in cases:
        assert error(rootio, fn) == error(jax_rootio, fn)
    bad = tmp_path / "bad.root"
    bad.write_bytes(b"not a root file at all" + b"\x00" * 100)
    assert (error(rootio, lambda m: m.RootFile(str(bad)))
            == error(jax_rootio, lambda m: m.RootFile(str(bad))))
    stub = tmp_path / "stub.root"
    stub.write_bytes(b"root")
    assert (error(rootio, lambda m: m.open_event_file(str(stub)))
            == error(jax_rootio, lambda m: m.open_event_file(str(stub))))


def test_codecs_reported():
    assert rootio.codecs() == {"zlib": "linked", "zstd": "dlopen",
                               "lz4": "dlopen", "lzma": "dlopen"}


_FUZZ = """
import sys
sys.path[:0] = [{repo!r}, {tools!r}]
from fuzz_rootio import mutate
from ubresnet_tpu_torch.data import rootio
base = open({base!r}, "rb").read()
for i in range(48):
    p = {work!r} + f"/m{{i}}.root"
    open(p, "wb").write(mutate(base, i if i < 16 else 48 + i, 16))
    try:
        with rootio.RootFile(p) as rf:
            for (tree, branch), _ in rf.branches().items():
                rf.read_event(tree, branch.rsplit(".", 1)[0], 0)
        rootio.inspect_file(p)
    except (IOError, ValueError, KeyError, IndexError):
        pass
print("survived", i + 1)
"""


def test_mutated_files_never_crash_the_reader(tmp_path):
    """48 seeded mutants (16 truncations, then 1-byte XORs and 4-byte
    extreme stamps) of a port-written file, read in a subprocess: any
    exception is fine, a dead process is not."""
    base = str(tmp_path / "base.root")
    _write(rootio, Image2D, ImageMeta, base, True)
    code = _FUZZ.format(repo=REPO, tools=os.path.join(REPO, "tools"),
                        base=base, work=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "survived 48" in proc.stdout
