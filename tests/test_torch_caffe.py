"""The port's caffe parity engine (ubresnet_tpu_torch.parity.caffe and
protobuf_lite, models/ssnet2018) against the JAX package's on the CPU:
the generated prototxt and its parse, .caffemodel bytes and parses both
ways, the seeded weights array for array at the flagship width, every
op of the executor on small graphs, and the whole ssnet2018 graph at
inplanes 4, 64x64, blob for blob."""
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubresnet_tpu.models.ssnet2018 import ssnet2018_prototxt as jax_prototxt
from ubresnet_tpu.parity import caffe as jcaffe
from ubresnet_tpu_torch.data.synthetic import synth_event
from ubresnet_tpu_torch.models.ssnet2018 import ssnet2018_prototxt
from ubresnet_tpu_torch.parity import caffe
from ubresnet_tpu_torch.parity import protobuf_lite as pb

torch.set_num_threads(1)

# every blob of a forward within this share of the blob's largest
# magnitude of JAX's (f32 sums in another order; measured ≈ 3e-6 over
# the whole ssnet2018 graph), softmax probabilities within SOFTMAX_TOL
REL_TOL = 1e-4
SOFTMAX_TOL = 1e-5


def _port(text, **kw):
    return caffe.CaffeNet(text, device="cpu", **kw)


def _forwards(text, x, weights=None, seed=0):
    """(JAX blobs, port blobs) of the graph ``text`` on NHWC ``x``."""
    jn = jcaffe.CaffeNet(text, weights=weights, seed=seed)
    want = {k: np.asarray(v) for k, v in
            jn.forward(jn.params, jnp.asarray(x)).items()}
    with torch.inference_mode():
        got = {k: v.numpy() for k, v in
               _port(text, weights=weights, seed=seed)(
                   torch.from_numpy(x)).items()}
    return want, got


def _assert_blobs_close(want, got):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == np.float32, k
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= REL_TOL * scale, (k, err, scale)
    if "softmax" in want:
        np.testing.assert_allclose(got["softmax"], want["softmax"],
                                   rtol=0, atol=SOFTMAX_TOL)


@pytest.mark.parametrize("inplanes", [4, 16])
def test_prototxt_and_its_parse_equal_jax(inplanes):
    for kw in ({}, {"num_classes": 5, "input_dim": (2, 1, 64, 96)}):
        text = ssnet2018_prototxt(inplanes=inplanes, **kw)
        assert text == jax_prototxt(inplanes=inplanes, **kw)
        assert caffe.parse_prototxt(text) == jcaffe.parse_prototxt(text)
    odd = ('# a comment\nname: "x" # trailing\nflag: true\nother: FALSE\n'
           'mode: MAX\nf: -1.5e-3\nn: 7\nlayer { a: "q r" b { c: 1 } }\n'
           'layer { a: "s", b { c: 2 } }\n')
    assert caffe.parse_prototxt(odd) == jcaffe.parse_prototxt(odd)


def test_caffemodel_bytes_and_parses_both_ways(tmp_path):
    """write_caffemodel writes JAX's bytes; each package's parser reads
    each package's file, and a hand-built NetParameter with V1 layers,
    legacy num/channels/height/width dims, unpacked floats, packed shape
    varints and fields the reader skips, to the same arrays."""
    rng = np.random.RandomState(3)
    layers = {"conv0": [rng.randn(4, 1, 3, 3).astype(np.float32),
                        rng.randn(4).astype(np.float32)],
              "bn0": [rng.randn(4).astype(np.float32),
                      np.abs(rng.randn(4)).astype(np.float32),
                      np.ones(1, np.float32)],
              "big": [rng.randn(3, 300, 2, 2).astype(np.float32)]}
    paths = {}
    for tag, mod in (("port", caffe), ("jax", jcaffe)):
        paths[tag] = str(tmp_path / f"{tag}.caffemodel")
        mod.write_caffemodel(paths[tag], layers)
    with open(paths["port"], "rb") as f, open(paths["jax"], "rb") as g:
        assert f.read() == g.read()

    blob = (pb.field_varint(1, 2) + pb.field_varint(2, 1)
            + pb.field_varint(4, 3)
            + b"".join(pb.tag(5, pb.WIRE_32BIT) + struct.pack("<f", v)
                       for v in rng.randn(6)))
    v1 = (pb.field_string(4, "legacy") + pb.field_bytes(6, blob)
          + pb.tag(9, pb.WIRE_64BIT) + b"\0" * 8)
    shape = pb.field_bytes(1, pb.write_varint(2) + pb.write_varint(3))
    packed = pb.field_bytes(7, shape) + pb.field_packed_floats(
        5, rng.randn(6))
    new = (pb.field_string(1, "packed") + pb.field_string(2, "Convolution")
           + pb.field_bytes(7, packed))
    odd = str(tmp_path / "odd.caffemodel")
    with open(odd, "wb") as f:
        f.write(pb.field_string(1, "net") + pb.field_bytes(2, v1)
                + pb.field_bytes(100, new))
    for path in (paths["port"], paths["jax"], odd):
        got, want = caffe.parse_caffemodel(path), jcaffe.parse_caffemodel(path)
        assert list(got) == list(want)
        for name in want:
            assert len(got[name]) == len(want[name])
            for a, b in zip(got[name], want[name]):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
                a += 1  # a fresh writable array, not a view of the file
    assert caffe.parse_caffemodel(odd)["legacy"][0].shape == (2, 1, 1, 3)


def test_weights_equal_jax_at_flagship_width():
    """CaffeNet(prototxt, seed=s).params equals the JAX net's array for
    array at inplanes 16: the same draws in the same layer order, msra
    fan_in = prod(shape[1:]), grouped bilinear deconvs dense."""
    text = ssnet2018_prototxt()
    want = jcaffe.CaffeNet(text, seed=101).params
    got = _port(text, seed=101).params
    assert list(got) == list(want)
    for name in want:
        for a, b in zip(got[name], want[name]):
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert got["deconv0_deconv"][0].shape == (512, 256, 4, 4)
    assert sum(b.size for v in got.values() for b in v) > 18e6


def _conv(name, bottom, top, cout, k=3, pad=1, extra=""):
    return (f'layer {{ name: "{name}" type: "Convolution" bottom: "{bottom}"'
            f' top: "{top}" convolution_param {{ num_output: {cout}'
            f' kernel_size: {k} pad: {pad} {extra}'
            ' weight_filler { type: "msra" } } }\n')


def _net(c, h, w, body):
    return (f'name: "t"\ninput: "data"\ninput_dim: 1\ninput_dim: {c}\n'
            f'input_dim: {h}\ninput_dim: {w}\n' + body)


DECONV = ('layer {{ name: "dec" type: "Deconvolution" bottom: "a" top: "dec"'
          ' convolution_param {{ num_output: {cout} {args} weight_filler'
          ' {{ type: "{filler}" }} }} }}\n')
DECONVS = {
    "grouped_bilinear": dict(cout=6, args="pad: 1 kernel_size: 4 group: 6 "
                             "stride: 2", filler="bilinear"),
    "grouped_msra": dict(cout=3, args="pad: 1 kernel_size: 4 group: 3 "
                         "stride: 2", filler="msra"),
    "dense": dict(cout=5, args="pad: 1 kernel_size: 4 stride: 2",
                  filler="msra"),
    "k3_s3_nobias": dict(cout=4, args="pad: 0 kernel_size: 3 stride: 3 "
                         "bias_term: false", filler="msra"),
}


@pytest.mark.parametrize("case", sorted(DECONVS))
def test_deconv_matches_jax(case):
    """F.conv_transpose2d on the caffe blob as it stands is JAX's
    input-dilated conv of the flipped kernel: grouped (expanded dense at
    load), dense, and an odd kernel/stride/pad without bias."""
    text = _net(2, 7, 9, _conv("a", "data", "a", 6)
                + DECONV.format(**DECONVS[case]))
    x = np.random.RandomState(1).randn(2, 7, 9, 2).astype(np.float32)
    want, got = _forwards(text, x, seed=4)
    _assert_blobs_close(want, got)


def test_deconv_weights_given_grouped_or_dense():
    """Weights handed in grouped (cin, cout/group, k, k) are expanded;
    weights already dense are taken as they are; both run as JAX's."""
    text = _net(2, 6, 6, _conv("a", "data", "a", 6) + DECONV.format(
        **DECONVS["grouped_bilinear"]))
    rng = np.random.RandomState(2)
    grouped = rng.randn(6, 1, 4, 4).astype(np.float32)
    dense = caffe._expand_grouped_deconv(grouped, 6, 6, 6, 4)
    bias = rng.randn(6).astype(np.float32)
    x = rng.randn(1, 6, 6, 2).astype(np.float32)
    outs = []
    for w in (grouped, dense):
        want, got = _forwards(text, x, weights={"dec": [w, bias]})
        _assert_blobs_close(want, got)
        np.testing.assert_array_equal(
            _port(text, weights={"dec": [w, bias]}).params["dec"][0], dense)
        outs.append(got["dec"])
    np.testing.assert_array_equal(outs[0], outs[1])


POOLS = [(15, 15, 3, 2, 0), (16, 13, 3, 2, 1), (9, 11, 2, 2, 1),
         (7, 8, 3, 3, 0), (10, 10, 2, 3, 0), (11, 9, 2, 3, 1), (6, 7, 3, 1, 2),
         (64, 64, 3, 2, 0)]


@pytest.mark.parametrize("h,w,k,s,pad", POOLS)
def test_ceil_pooling_matches_jax(h, w, k, s, pad):
    """Caffe's ceil mode with the clip rule at odd sizes, with padding
    (-inf on the high side), a kernel smaller than its stride, with and
    without a clipped window, and a pad past half the kernel; 64 pools
    to 32, not floor's 31."""
    text = _net(2, h, w, 'layer { name: "p" type: "Pooling" bottom: "data"'
                f' top: "p" pooling_param {{ kernel_size: {k} stride: {s}'
                f' pad: {pad} pool: MAX }} }}\n')
    x = np.random.RandomState(h * w).randn(2, h, w, 2).astype(np.float32)
    want, got = _forwards(text, x)
    np.testing.assert_array_equal(got["p"], want["p"])
    if (h, k, s, pad) == (64, 3, 2, 0):
        assert got["p"].shape[1] == 32


def test_batchnorm_scale_and_zero_scale_factor():
    """BatchNorm with sf = 0 (the scalar taken as 1) folded with the
    Scale (no bias) on its blob, and a lone BatchNorm with sf = 2."""
    rng = np.random.RandomState(5)
    body = (_conv("a", "data", "a", 4)
            + 'layer { name: "bn" type: "BatchNorm" bottom: "a" top: "a" }\n'
            'layer { name: "sc" type: "Scale" bottom: "a" top: "a"'
            ' scale_param { bias_term: false } }\n'
            + _conv("b", "a", "b", 3)
            + 'layer { name: "bn2" type: "BatchNorm" bottom: "b" top: "b" }\n')
    weights = {"bn": [rng.randn(4).astype(np.float32),
                      rng.rand(4).astype(np.float32) + 0.5,
                      np.zeros(1, np.float32)],
               "sc": [rng.randn(4).astype(np.float32)],
               "bn2": [rng.randn(3).astype(np.float32),
                       rng.rand(3).astype(np.float32) + 0.5,
                       np.full(1, 2.0, np.float32)]}
    x = rng.randn(1, 8, 8, 2).astype(np.float32)
    want, got = _forwards(_net(2, 8, 8, body), x, weights=weights)
    _assert_blobs_close(want, got)


def test_eltwise_crop_dropout_concat_softmax():
    """PROD and MAX Eltwise (coefficients ignored, three bottoms), Crop
    at offset 0 onto a smaller blob, a TEST-mode Dropout, Concat, a
    grouped dilated conv and Softmax. The Crop and Dropout tops alias
    their bottom; a later in-place ReLU on it must leave them as they
    were (no op writes in place)."""
    body = (_conv("a", "data", "a", 4)
            + _conv("b", "data", "b", 4, k=3, pad=2,
                    extra="dilation: 2 group: 2")
            + 'layer { name: "small" type: "Pooling" bottom: "a" top: "small"'
            ' pooling_param { kernel_size: 2 stride: 2 pool: MAX } }\n'
            'layer { name: "crop" type: "Crop" bottom: "a" bottom: "small"'
            ' top: "crop" }\n'
            'layer { name: "drop" type: "Dropout" bottom: "a" top: "d" }\n'
            'layer { name: "r" type: "ReLU" bottom: "a" top: "a" }\n'
            'layer { name: "prod" type: "Eltwise" bottom: "a" bottom: "b"'
            ' top: "prod" eltwise_param { operation: PROD } }\n'
            'layer { name: "max" type: "Eltwise" bottom: "a" bottom: "b"'
            ' bottom: "d" top: "max" eltwise_param { operation: MAX } }\n'
            'layer { name: "sum" type: "Eltwise" bottom: "prod" bottom: "max"'
            ' top: "sum" eltwise_param { operation: SUM coeff: 2 coeff: 3 }'
            ' }\n'
            'layer { name: "cat" type: "Concat" bottom: "sum" bottom: "d"'
            ' top: "cat" }\n'
            'layer { name: "softmax" type: "Softmax" bottom: "cat"'
            ' top: "softmax" }\n')
    x = np.random.RandomState(6).randn(2, 9, 10, 2).astype(np.float32)
    want, got = _forwards(_net(2, 9, 10, body), x, seed=2)
    _assert_blobs_close(want, got)
    assert (got["d"] < 0).any() and (got["crop"] < 0).any()
    assert got["crop"].shape == (2, 5, 5, 4)


def test_double_runs_the_same_graph_in_float64():
    text = _net(2, 8, 8, _conv("a", "data", "a", 4) + DECONV.format(
        **DECONVS["dense"]))
    net = _port(text, seed=3)
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 8, 8, 2)
                         .astype(np.float32))
    with torch.inference_mode():
        f32 = net(x)["dec"]
        f64 = net.double()(x)["dec"]
    assert f64.dtype == torch.float64
    torch.testing.assert_close(f64.float(), f32, rtol=1e-5, atol=1e-5)


def test_tf32_off_for_the_forward_only(monkeypatch):
    """The oracle's forward runs with TF32 off; building and running a
    net leaves the process's settings as it found them."""
    flags = (torch.backends.cudnn, torch.backends.cuda.matmul)
    for f in flags:
        monkeypatch.setattr(f, "allow_tf32", True)
    net = _port(_net(2, 8, 8, _conv("a", "data", "a", 4)), seed=3)
    seen = []
    run = net._run
    monkeypatch.setattr(net, "_run", lambda x: (
        seen.append([f.allow_tf32 for f in flags]), run(x))[1])
    with torch.inference_mode():
        net(torch.zeros(1, 8, 8, 2))
    assert seen == [[False, False]]
    assert [f.allow_tf32 for f in flags] == [True, True]


@pytest.fixture(scope="module")
def ssnet_forwards():
    """JAX's (jitted) and the port's forward of the ssnet2018 graph at
    inplanes 4 on a 64x64 synthetic event. The msra-filled head puts
    the logits near 1e4, where softmax is saturated and a last-bit
    difference flips near-ties; the classifier conv11 is scaled by 1e-4
    so they are O(1)."""
    text = ssnet2018_prototxt(inplanes=4)
    weights = {k: list(v) for k, v in _port(text, seed=5).params.items()}
    weights["conv11"][0] = weights["conv11"][0] * np.float32(1e-4)
    x = synth_event(np.random.RandomState(4), (64, 64))["wire"]
    x = np.ascontiguousarray(x[None, ..., None])
    jn = jcaffe.CaffeNet(text, weights=weights)
    fwd = jax.jit(jn.forward)
    want = {k: np.asarray(v) for k, v in
            fwd(jn.params, jnp.asarray(x)).items()}
    with torch.inference_mode():
        got = {k: v.numpy() for k, v in
               _port(text, weights=weights)(torch.from_numpy(x)).items()}
    return want, got


def test_ssnet2018_every_blob_matches_jax(ssnet_forwards):
    want, got = ssnet_forwards
    _assert_blobs_close(want, got)
    assert got["softmax"].shape == (1, 64, 64, 3)
    assert got["res5b"].shape[1] == 2 and got["deconv0_deconv"].shape[1] == 4
    assert 0.4 < got["softmax"].max() < 0.999  # unsaturated
    np.testing.assert_allclose(got["softmax"].sum(-1), 1.0, atol=1e-5)
