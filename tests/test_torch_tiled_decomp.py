"""The decomposition the tensor-core K2 (ops/csrc/basic_block.cu) and K3
(ops/csrc/deconv2x.cu) compute, written out in plain torch on the CPU,
against the plain versions (ops/block.py:basic_block_plain,
ops/deconv.py:deconv2x_plain) and the JAX Pallas kernels in interpret
mode (fused_basic_block, fused_dual_block, fused_packed_deconv2x):

- halo tiles: a 16x16 output tile (the kernels' size) reads a 20x20 x
  tile and a 18x18 m tile, zero-filled outside the image, and the last
  tile row and column are cut at the border (also at 5x7 tiles, which
  divide none of the sizes here);
- the implicit GEMM: im2col rows are tile pixels, K is tap-major, then
  channel — exactly the (kh, kw, ci, co) weight read as a K x co matrix;
- m is zero outside the image (conv2's own padding), not relu(bn1(..))
  of the padding, and the halo inside the image is real conv1 output;
- the deconv: one input tile with a one-pixel halo gives all four output
  parity classes, each a GEMM [pixels x 4 ci] x [4 ci x co].

float32 throughout; tolerances as tests/test_torch_kernels.py (2e-4 for
the two-conv blocks, 2e-5 for the deconv): sums in another order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubresnet_tpu.ops.packed import pack, tile_channel_vector, unpack
from ubresnet_tpu.ops.pallas_conv import (
    fused_basic_block,
    fused_dual_block,
    fused_packed_deconv2x,
)
from ubresnet_tpu_torch.ops import block, deconv

torch.set_num_threads(1)

TILES = [(16, 16), (5, 7)]


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _window(x, y0, x0, h, w):
    """x[:, y0:y0+h, x0:x0+w] of an NHWC image, zero outside it."""
    bsz, hh, ww, c = x.shape
    out = x.new_zeros(bsz, h, w, c)
    ys, xs = max(y0, 0), max(x0, 0)
    ye, xe = min(y0 + h, hh), min(x0 + w, ww)
    if ye > ys and xe > xs:
        out[:, ys - y0:ye - y0, xs - x0:xe - x0] = x[:, ys:ye, xs:xe]
    return out


def _im2col(tile, oh, ow, taps):
    """Rows: the oh x ow pixels of the tile's output, row-major; K:
    tap-major over ``taps`` (dy, dx offsets into the tile), then
    channel."""
    cols = [tile[:, dy:dy + oh, dx:dx + ow] for dy, dx in taps]
    return torch.cat(cols, -1).reshape(tile.shape[0], oh * ow, -1)


TAPS3 = [(dy, dx) for dy in range(3) for dx in range(3)]


def block_tiled(a, b, w1, g1, b1, w2, g2, b2, wb=None, gb=None, bb=None,
                tile=(16, 16), zero_m=True):
    """K2's decomposition: per output tile, conv1 as one GEMM over the
    tile's m pixels with their halo (zeroed outside the image), m
    rounded to a.dtype, conv2 and the bypass as GEMMs over the tile."""
    th, tw = tile
    x = a.float() if b is None else torch.cat([a.float(), b.float()], -1)
    bsz, h, w, cin = x.shape
    co = w1.shape[-1]
    k1 = w1.float().reshape(9 * cin, co)  # (kh, kw, ci) rows: tap-major
    k2 = w2.float().reshape(9 * co, co)
    out = torch.empty(bsz, h, w, co)
    for oh0 in range(0, h, th):
        for ow0 in range(0, w, tw):
            xt = _window(x, oh0 - 2, ow0 - 2, th + 4, tw + 4)
            m = torch.relu(_im2col(xt, th + 2, tw + 2, TAPS3) @ k1 * g1 + b1)
            if zero_m:
                iy = torch.arange(oh0 - 1, oh0 + th + 1)
                ix = torch.arange(ow0 - 1, ow0 + tw + 1)
                inside = (((iy >= 0) & (iy < h))[:, None]
                          & ((ix >= 0) & (ix < w))[None, :]).reshape(-1, 1)
                m = m * inside
            m = m.to(a.dtype).float().reshape(bsz, th + 2, tw + 2, co)
            y = torch.relu(_im2col(m, th, tw, TAPS3) @ k2 * g2 + b2)
            centre = xt[:, 2:2 + th, 2:2 + tw].reshape(bsz, th * tw, cin)
            r = centre @ wb.float() * gb + bb if wb is not None else centre
            o = torch.relu(y + r).reshape(bsz, th, tw, co)
            out[:, oh0:oh0 + th, ow0:ow0 + tw] = o[:, :h - oh0, :w - ow0]
    return out.to(a.dtype)


def _tap(parity, s):
    """(kernel index k, input offset di) of tap s of an output parity:
    o = 2i + k - 1."""
    if parity == 0:
        return (1, 0) if s == 0 else (3, -1)
    return (2, 0) if s == 0 else (0, 1)


def deconv_tiled(x, w, tile=(16, 16)):
    """K3's decomposition: per input tile (with a one-pixel halo), the
    four parity classes, each [pixels x 4 ci] @ [4 ci x co] with K
    tap-major over the class's taps (2 sr + sc), interleaved into the
    2x output."""
    qh, qw = tile
    x = x.float()
    bsz, h, wd, ci = x.shape
    co = w.shape[-1]
    out = torch.empty(bsz, 2 * h, 2 * wd, co)
    for qy0 in range(0, h, qh):
        for qx0 in range(0, wd, qw):
            xt = _window(x, qy0 - 1, qx0 - 1, qh + 2, qw + 2)
            ny, nx = min(qh, h - qy0), min(qw, wd - qx0)
            for pa in range(2):
                for pb in range(2):
                    taps, kmat = [], []
                    for s in range(4):
                        kh, di = _tap(pa, s // 2)
                        kw, dj = _tap(pb, s % 2)
                        taps.append((1 + di, 1 + dj))
                        kmat.append(w.float()[kh, kw])
                    y = _im2col(xt, qh, qw, taps) @ torch.cat(kmat, 0)
                    y = y.reshape(bsz, qh, qw, co)[:, :ny, :nx]
                    out[:, 2 * qy0 + pa:2 * (qy0 + ny):2,
                        2 * qx0 + pb:2 * (qx0 + nx):2] = y
    return out.to(x.dtype)


def _affine(rng, co):
    return ((rng.rand(co) + 0.5).astype(np.float32),
            (rng.randn(co) * 0.1).astype(np.float32))


def _block_inputs(rng, bsz, h, w, ca, cb, co, proj):
    cin = ca + cb
    a = np.abs(rng.randn(bsz, h, w, ca)).astype(np.float32)
    b = np.abs(rng.randn(bsz, h, w, cb)).astype(np.float32) if cb else None
    w1 = (rng.randn(3, 3, cin, co) * 0.1).astype(np.float32)
    w2 = (rng.randn(3, 3, co, co) * 0.1).astype(np.float32)
    wb = (rng.randn(cin, co) * 0.1).astype(np.float32) if proj else None
    (g1, b1), (g2, b2), (gb, bb) = (_affine(rng, co) for _ in range(3))
    return a, b, w1, g1, b1, w2, g2, b2, wb, gb, bb


def _torch_args(args, proj):
    a, b, w1, g1, b1, w2, g2, b2, wb, gb, bb = args
    opt = (lambda v: _t(v) if proj else None)  # noqa: E731
    return (_t(a), None if b is None else _t(b), _t(w1), _t(g1), _t(b1),
            _t(w2), _t(g2), _t(b2), opt(wb), opt(gb), opt(bb))


@pytest.mark.parametrize("tile", TILES, ids=["16x16", "5x7"])
@pytest.mark.parametrize("shape", sorted(block.SHAPES))
def test_block_decomposition_matches_plain(rng, shape, tile):
    """Every compiled (ca, cb, co, proj) at 20x37: 16x16 tiles cut at
    the border, 5x7 tiles dividing neither side."""
    ca, cb, co, proj = shape
    args = _torch_args(_block_inputs(rng, 2, 20, 37, ca, cb, co, proj), proj)
    got = block_tiled(*args, tile=tile)
    want = block.basic_block_plain(*args)
    assert got.shape == want.shape == (2, 20, 37, co)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4)


def test_block_m_is_zero_outside_the_image(rng):
    """The border needs m = 0 outside the image: relu(bn1(conv1)) of the
    zero padding (bn1's bias) instead moves the border pixels only."""
    args = _torch_args(_block_inputs(rng, 1, 12, 12, 16, 0, 16, False),
                       False)
    want = block.basic_block_plain(*args)
    np.testing.assert_allclose(block_tiled(*args).numpy(), want.numpy(),
                               atol=2e-4)
    wrong = block_tiled(*args, zero_m=False)
    err = (wrong - want).abs().amax(-1)[0]
    assert float(err[1:-1, 1:-1].max()) <= 2e-4
    assert float(torch.cat([err[0], err[-1], err[:, 0], err[:, -1]]).max()) \
        > 1e-2


@pytest.mark.parametrize("tile", TILES, ids=["16x16", "5x7"])
@pytest.mark.parametrize(
    "p,ci,co,proj",
    [(8, 16, 32, True),    # enc1.res1 form
     (4, 32, 32, False),   # enc1.res2 / dec2.res.res2 form
     (8, 16, 16, False)],  # dec1.res.res2 form
)
def test_block_decomposition_matches_pallas(rng, p, ci, co, proj, tile):
    bsz, h, w = 2, 8, 8 * p
    args = _block_inputs(rng, bsz, h, w, ci, 0, co, proj)
    x, _, w1, g1, b1, w2, g2, b2, wb, gb, bb = args
    j, tcv = jnp.asarray, tile_channel_vector
    want = unpack(fused_basic_block(
        pack(j(x), p), j(w1), tcv(j(g1), p), tcv(j(b1), p), j(w2),
        tcv(j(g2), p), tcv(j(b2), p), j(wb)[None, None] if proj else None,
        tcv(j(gb), p) if proj else None, tcv(j(bb), p) if proj else None,
        p=p, th=4, interpret=True), p)
    got = block_tiled(*_torch_args(args, proj), tile=tile)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("tile", TILES, ids=["16x16", "5x7"])
@pytest.mark.parametrize("p,ci,co", [(4, 32, 32), (8, 16, 16)])
def test_dual_block_decomposition_matches_pallas(rng, p, ci, co, tile):
    """The dual form (dec2/dec1 res.res1): x is the channel concat of
    the two streams inside the tile only."""
    bsz, h, w = 2, 8, 8 * p
    args = _block_inputs(rng, bsz, h, w, ci, ci, co, True)
    a, b, w1, g1, b1, w2, g2, b2, wb, gb, bb = args
    j, tcv = jnp.asarray, tile_channel_vector
    want = unpack(fused_dual_block(
        pack(j(a), p), pack(j(b), p), j(w1), tcv(j(g1), p), tcv(j(b1), p),
        j(w2), tcv(j(g2), p), tcv(j(b2), p), j(wb)[None, None],
        tcv(j(gb), p), tcv(j(bb), p), p=p, th=4, interpret=True), p)
    got = block_tiled(*_torch_args(args, True), tile=tile)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("tile", TILES, ids=["16x16", "5x7"])
@pytest.mark.parametrize("shape", sorted(deconv.SHAPES))
def test_deconv_decomposition_matches_plain(rng, shape, tile):
    ci, co = shape
    x = _t(rng.randn(2, 19, 35, ci))
    w = _t(rng.randn(4, 4, ci, co) * 0.1)
    got = deconv_tiled(x, w, tile)
    want = deconv.deconv2x_plain(x, w)
    assert got.shape == want.shape == (2, 38, 70, co)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)


@pytest.mark.parametrize("tile", TILES, ids=["16x16", "5x7"])
@pytest.mark.parametrize("p,ci,co,h,w",
                         [(4, 64, 32, 8, 64), (8, 32, 16, 8, 128)])
def test_deconv_decomposition_matches_pallas(rng, p, ci, co, h, w, tile):
    """dec2 and dec1 forms against fused_packed_deconv2x."""
    x = rng.randn(2, h, w, ci).astype(np.float32)
    wt = (rng.randn(4, 4, ci, co) * 0.1).astype(np.float32)
    want = unpack(fused_packed_deconv2x(
        pack(jnp.asarray(x), p), jnp.asarray(wt), p=p, th=4,
        interpret=True), p)
    got = deconv_tiled(_t(x), _t(wt), tile)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_gemm_k_order_is_the_weight_layout(rng):
    """The implicit GEMM's K index (tap-major, then channel) is the row
    of the (kh, kw, ci, co) weight read as a (9 ci) x co matrix: column
    kk of the im2col row of pixel (y, x) is x[y + kk // (3 ci) - 1,
    x + (kk // ci) % 3 - 1, kk % ci]."""
    ci = 16
    x = _t(rng.randn(1, 6, 7, ci))
    cols = _im2col(_window(x, -1, -1, 8, 9), 6, 7, TAPS3)[0]
    for pix, kk in ((0, 0), (9, 5 * ci + 3), (41, 9 * ci - 1), (20, 4 * ci)):
        y, xx = divmod(pix, 7)
        dy, dx, c = kk // (3 * ci), (kk // ci) % 3, kk % ci
        yy, xs = y + dy - 1, xx + dx - 1
        inside = 0 <= yy < 6 and 0 <= xs < 7
        assert float(cols[pix, kk]) == (float(x[0, yy, xs, c]) if inside
                                        else 0.0)
