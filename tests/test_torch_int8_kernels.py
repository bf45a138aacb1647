"""The plain versions of the port's int8 kernels (K1-s8, K2-s8, K3-s8 in
ubresnet_tpu_torch/ops; the wrappers take them for CPU tensors) against
the JAX package's Pallas kernels in their quantized mode, in interpret
mode on W-packed tensors, fed the same int8 inputs and the same folded
gains, float32 outputs. Tolerances are those of tests/test_quant.py:
rtol 1e-6 with atol 1e-5 for the conv and the deconv, 1e-4 for the
blocks (f32 epilogues). The requantized block intermediate is compared
exactly against the same requant of XLA's packed int8 conv."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubresnet_tpu.ops.packed import pack, packed_conv, tile_channel_vector, unpack
from ubresnet_tpu.ops.pallas_conv import (
    fused_basic_block,
    fused_dual_block,
    fused_packed_conv,
    fused_packed_deconv2x,
)
from ubresnet_tpu_torch.ops import _build, block, conv, deconv

torch.set_num_threads(1)
F32 = torch.float32


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _s8(rng, shape, lim=127):
    return rng.randint(-lim, lim + 1, shape).astype(np.int8)


def _affine(rng, co, scale):
    return (np.abs(rng.randn(co)).astype(np.float32) * scale,
            (rng.randn(co) * 3).astype(np.float32))


@pytest.mark.parametrize("mode", ["act", "pre_act_residual", "no_act"])
def test_conv_s8_matches_pallas(mode):
    """K1-s8 at the flagship head's compiled shape (16 → 16, 7x7)."""
    ci, co, k = 16, 16, 7
    assert (ci, co, k) in conv.S8_SHAPES
    p = 128 // ci
    rng = np.random.RandomState(3)
    x = _s8(rng, (2, 16, 4 * p, ci))
    w = _s8(rng, (k, k, ci, co))
    g = (rng.randn(co) * 0.01).astype(np.float32)
    b = rng.randn(co).astype(np.float32)
    res = rng.randn(2, 16, 4 * p, co).astype(np.float32)
    residual = res if mode == "pre_act_residual" else None
    pre_act, act = mode == "pre_act_residual", mode != "no_act"
    want = unpack(fused_packed_conv(
        pack(jnp.asarray(x), p), jnp.asarray(w), jnp.tile(jnp.asarray(g), p),
        jnp.tile(jnp.asarray(b), p), p=p,
        residual=None if residual is None else pack(jnp.asarray(res), p),
        pre_act=pre_act, act=act, out_dtype=jnp.float32, interpret=True), p)
    got = conv.conv_bn_act_s8(_t(x), _t(w), _t(g), _t(b),
                              None if residual is None else _t(res),
                              pre_act=pre_act, act=act, out_dtype=F32)
    assert got.dtype == F32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)


def _requant_ref(xq, w1q, g1, b1, p):
    """m as tests/test_quant.py's _block_ref_int8 forms it: XLA's packed
    s32 conv, the f32 affine, ReLU, round(min(·, 127))."""
    acc = packed_conv(pack(jnp.asarray(xq), p), jnp.asarray(w1q), p, 1,
                      preferred=jnp.int32)
    y = jnp.maximum(acc.astype(jnp.float32) * tile_channel_vector(
        jnp.asarray(g1), p) + tile_channel_vector(jnp.asarray(b1), p), 0.0)
    return np.asarray(unpack(jnp.round(jnp.minimum(y, 127.0)), p)).astype(
        np.int8)


@pytest.mark.parametrize("shape", sorted(block.S8_SHAPES))
def test_block_s8_matches_pallas(shape):
    """K2-s8 at each compiled shape: projection and identity bypass,
    single and dual stream (one shared scale); g1 spans the int8 grid
    of the requantized intermediate, saturation at 127 included."""
    ca, cb, co, proj = shape
    cin = ca + cb
    p = 128 // ca
    rng = np.random.RandomState(5 + ca + cb + co)
    a = _s8(rng, (2, 16, 4 * p, ca))
    b = _s8(rng, (2, 16, 4 * p, cb)) if cb else None
    w1 = _s8(rng, (3, 3, cin, co), 64)
    w2 = _s8(rng, (3, 3, co, co), 64)
    wb = _s8(rng, (1, 1, cin, co), 64) if proj else None
    # conv1's accumulator has std ≈ 2700·sqrt(9·cin): this g1 puts the
    # requantized m at std ≈ 60 on the grid, saturating its tail at 127
    g1, b1 = _affine(rng, co, 0.028 / np.sqrt(9 * cin))
    g2, b2 = _affine(rng, co, 1e-3)
    if proj:
        gb, bb = _affine(rng, co, 1e-3)
    else:
        gb, bb = np.full(co, 0.05, np.float32), np.zeros(co, np.float32)
    j, tcv = jnp.asarray, tile_channel_vector
    aff = [tcv(j(v), p) for v in (g1, b1, g2, b2, gb, bb)]
    if cb:
        want = fused_dual_block(
            pack(j(a), p), pack(j(b), p), j(w1), aff[0], aff[1], j(w2),
            aff[2], aff[3], j(wb), aff[4], aff[5], p=p,
            out_dtype=jnp.float32, interpret=True)
    else:
        want = fused_basic_block(
            pack(j(a), p), j(w1), aff[0], aff[1], j(w2), aff[2], aff[3],
            j(wb) if proj else None, aff[4], aff[5], p=p,
            out_dtype=jnp.float32, interpret=True)
    got, m = block.basic_block_s8_plain(
        _t(a), None if b is None else _t(b), _t(w1), _t(g1), _t(b1), _t(w2),
        _t(g2), _t(b2), _t(wb[0, 0]) if proj else None, _t(gb), _t(bb),
        out_dtype=F32, with_mid=True)
    via_wrapper = block.basic_block_s8(
        _t(a), None if b is None else _t(b), _t(w1), _t(g1), _t(b1), _t(w2),
        _t(g2), _t(b2), _t(wb[0, 0]) if proj else None, _t(gb), _t(bb),
        out_dtype=F32)
    assert torch.equal(got, via_wrapper)
    np.testing.assert_allclose(got.numpy(), np.asarray(unpack(want, p)),
                               rtol=1e-6, atol=1e-4)
    xq = a if b is None else np.concatenate([a, b], -1)
    ref_m = _requant_ref(xq, w1, g1, b1, p)
    flips = int((m.numpy() != ref_m).sum())
    if flips:
        print(f"{shape}: {flips} requant .5 flips of {m.numel()}")
    assert flips == 0
    assert int(m.max()) == 127 and int(m.min()) == 0


@pytest.mark.parametrize("shape", sorted(deconv.S8_SHAPES))
def test_deconv_s8_matches_pallas(shape):
    """K3-s8 at the dec2 and dec1 shapes: dequant g = sx·sw."""
    ci, co = shape
    p = 128 // ci
    rng = np.random.RandomState(8 + ci)
    x = _s8(rng, (2, 8, 4 * p, ci))
    w = _s8(rng, (4, 4, ci, co), 64)
    g = (np.abs(rng.randn(co)) * 1e-3).astype(np.float32)
    want = unpack(fused_packed_deconv2x(
        pack(jnp.asarray(x), p), jnp.asarray(w),
        tile_channel_vector(jnp.asarray(g), 2 * p), p=p,
        out_dtype=jnp.float32, interpret=True), p)
    got = deconv.deconv2x_s8(_t(x), _t(w), _t(g), out_dtype=F32)
    assert got.shape == want.shape == (2, 16, 8 * p, co)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)


def test_s8_shapes_have_one_table():
    """The s8 entry points dispatch from the X-macro lists of the one
    SHAPES table; K2-s8 and K3-s8 cover the bf16 kernels' zone shapes."""
    header = _build.shapes_header()
    for name, table in (("conv_bn_act_s8", conv.S8_SHAPES),
                        ("basic_block_s8", block.S8_SHAPES),
                        ("deconv2x_s8", deconv.S8_SHAPES)):
        macro = f"UBR_{name.upper()}_SHAPES"
        assert table is _build.SHAPES[name]
        line = next(ln for ln in header.splitlines() if macro + "(X)" in ln)
        assert line.count(" X(") == len(table)
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert f"{macro}(" in src and f"ubr_{name}(" in src
        assert f"ubr_{name}" in _build.SIGNATURES
    assert block.S8_SHAPES == block.SHAPES
    assert deconv.S8_SHAPES == deconv.SHAPES
    # the flagship head, and the 8-channel streams' head (inplanes 8)
    # and per-conv blocks' convs (inplanes 4)
    assert conv.S8_SHAPES == {(16, 16, 7), (8, 16, 7), (8, 8, 3), (8, 4, 3),
                              (8, 4, 1)}


def test_s8_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        _build.out_f32(torch.float16)
    assert not block.s8_supports(16, 16, 32, True)
    assert not conv.s8_supports(16, 3, 7)
