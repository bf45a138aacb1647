"""The decomposition the tensor-core K2 (ops/csrc/basic_block.cu), K3
(ops/csrc/deconv2x.cu), K1 (ops/csrc/conv_bn_act.cu, conv_gemm.cuh) and
K6 (ops/csrc/conv_dw.cu) compute, written out in plain torch on the CPU,
against the plain versions (ops/block.py:basic_block_plain,
ops/deconv.py:deconv2x_plain, ops/conv.py:conv_bn_act_plain and
conv_dw_plain) and the JAX Pallas kernels in interpret mode
(fused_basic_block, fused_dual_block, fused_packed_deconv2x,
fused_packed_conv, pallas_conv_ad's VJP, pallas_conv_dw):

- halo tiles: a 16x16 output tile (the kernels' size) reads a 20x20 x
  tile and a 18x18 m tile, zero-filled outside the image, and the last
  tile row and column are cut at the border (also at 5x7 tiles, which
  divide none of the sizes here);
- the implicit GEMM: im2col rows are tile pixels, K is tap-major, then
  channel — exactly the (kh, kw, ci, co) weight read as a K x co matrix;
- m is zero outside the image (conv2's own padding), not relu(bn1(..))
  of the padding, and the halo inside the image is real conv1 output;
- the deconv: one input tile with a one-pixel halo gives all four output
  parity classes, each a GEMM [pixels x 4 ci] x [4 ci x co];
- K1: per 16x16 output tile, [pixels x taps ci] @ [taps ci x co], N
  padded to a multiple of 8 (co = 3: columns 3-7 zero); at ci = 4 each
  pixel holds 8 channels (4-7 zero) and a 16-deep k-step covers two taps,
  the 49 taps padded by a phantom 50th whose weight rows are zero;
- K6: per 16x16 pixel tile and tap, x_shift^T @ dy (M = taps ci, K = the
  tile's pixels, one tile row a k-step, dy zeroed outside the image and
  co = 3 padded to 8), summed over the rows of each row group, over the
  tiles t = b, b + blocks, .. of each block, then the groups in order and
  the blocks' rows in order.

float32 throughout; tolerances as tests/test_torch_kernels.py (2e-4 for
the two-conv blocks, 2e-5 for the deconv and K1) and
tests/test_torch_train_kernels.py (K6 vs Pallas rtol 1e-4, atol 1e-3;
the dx leg 1e-4 / 1e-4): sums in another order. K6 against its f32
plain version: 1e-5 of the largest |dW|."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubresnet_tpu.ops.packed import pack, tile_channel_vector, unpack
from ubresnet_tpu.ops.pallas_conv import (
    fused_basic_block,
    fused_dual_block,
    fused_packed_conv,
    fused_packed_deconv2x,
    pallas_conv_ad,
    pallas_conv_dw,
)
from ubresnet_tpu_torch.ops import block, conv, deconv

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


# ---- K1: the tap-major implicit GEMM (conv_gemm.cuh)


def conv_tiled(x, w, g, b, residual=None, pre_act=False, act=True,
               tile=(16, 16)):
    """K1's decomposition: per output tile, the haloed x tile (zero
    outside the image) as im2col rows over the taps, times the weight as
    a padded K x N matrix, then the epilogue on the f32 sums."""
    th, tw = tile
    k, _, ci, co = w.shape
    r, taps = k // 2, [(dy, dx) for dy in range(k) for dx in range(k)]
    ct = 8 if ci == 4 else ci                # channels a tile pixel
    cop = -(-co // 8) * 8                    # N padded to n-tiles of 8
    if ct * len(taps) % 16:                  # ci = 4: a phantom tap
        taps.append(taps[-1])
    kmat = torch.zeros(len(taps) * ct, cop)  # row tap * ct + c
    for t in range(k * k):
        kmat[t * ct:t * ct + ci, :co] = w.float()[t // k, t % k]
    xp = torch.nn.functional.pad(x.float(), (0, ct - ci))
    bsz, h, wd, _ = x.shape
    out = torch.empty(bsz, h, wd, co)
    for oh0 in range(0, h, th):
        for ow0 in range(0, wd, tw):
            xt = _window(xp, oh0 - r, ow0 - r, th + k - 1, tw + k - 1)
            acc = (_im2col(xt, th, tw, taps) @ kmat)[..., :co]
            y = acc.reshape(bsz, th, tw, co) * g + b
            if pre_act:
                y = torch.relu(y)
            if residual is not None:
                y = y + _window(residual.float(), oh0, ow0, th, tw)
            if act:
                y = torch.relu(y)
            out[:, oh0:oh0 + th, ow0:ow0 + tw] = y[:, :h - oh0, :wd - ow0]
    return out.to(x.dtype)


def input_grad_tiled(dy, w):
    """The dx leg as conv_input_grad runs it on K1: the flipped,
    in/out-transposed kernel, 3 channels of dy padded to 4."""
    wt = w.flip((0, 1)).transpose(2, 3)
    co = dy.shape[-1]
    cp = -(-co // 4) * 4
    dy = torch.nn.functional.pad(dy, (0, cp - co))
    wt = torch.nn.functional.pad(wt, (0, 0, 0, cp - co))
    ci = wt.shape[-1]
    return conv_tiled(dy, wt, torch.ones(ci), torch.zeros(ci), act=False)


CONV_MODES = [(False, False, True), (True, True, True), (False, False, False)]
CONV_IDS = ["relu", "pre_relu+res+relu", "none"]


@pytest.mark.parametrize("mode", CONV_MODES, ids=CONV_IDS)
@pytest.mark.parametrize("shape", sorted(conv.SHAPES))
def test_conv_decomposition_matches_plain(rng, shape, mode):
    """Every compiled (ci, co, k) at 2 x 40 x 72 (16x16 tiles cut at the
    border in both directions), incl. co = 3 (N padded to 8) and ci = 4
    (two taps a k-step), with each epilogue."""
    ci, co, k = shape
    res, pre, act = mode
    x = _t(rng.randn(2, 40, 72, ci))
    w = _t(rng.randn(k, k, ci, co) * 0.1)
    g, b = (_t(v) for v in _affine(rng, co))
    r = _t(rng.randn(2, 40, 72, co)) if res else None
    got = conv_tiled(x, w, g, b, r, pre, act)
    want = conv.conv_bn_act_plain(x, w, g, b, r, pre_act=pre, act=act)
    assert got.shape == want.shape == (2, 40, 72, co)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)


def test_conv_two_taps_a_step_k_order(rng):
    """ci = 4: K row 16 s + kk is tap 2 s + kk // 8, channel kk % 8, and
    channels 4-7 and the phantom 50th tap carry zero weight rows — a
    nonzero value there would change the output."""
    x = _t(rng.randn(1, 20, 24, 4))
    w = _t(rng.randn(7, 7, 4, 16) * 0.1)
    ones, zeros = torch.ones(16), torch.zeros(16)
    want = conv.conv_bn_act_plain(x, w, ones, zeros, act=False)
    got = conv_tiled(x, w, ones, zeros, act=False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)
    taps = [(dy, dx) for dy in range(7) for dx in range(7)]
    taps.append(taps[-1])
    cols = _im2col(_window(torch.nn.functional.pad(x, (0, 4)), -3, -3, 22,
                           22), 16, 16, taps)[0]
    assert cols.shape == (256, 25 * 16)
    for kp in (0, 5, 8, 16 * 12 + 9, 16 * 24 + 3, 16 * 24 + 11):
        tap, c = kp // 8, kp % 8
        col = cols[:, kp]
        if c >= 4:
            assert float(col.abs().max()) == 0.0
        else:  # the phantom tap 49 reads tap 48's pixels, as the kernel
            dy, dx = divmod(min(tap, 48), 7)
            ref = _window(x, dy - 3, dx - 3, 16, 16)[0, ..., c].reshape(-1)
            assert torch.equal(col, ref)


@pytest.mark.parametrize(
    "p,ci,co,k,res,clf",
    [(8, 16, 16, 7, False, False),   # head conv10 form
     (8, 16, 16, 7, True, False),
     (8, 16, 3, 7, False, True),     # classifier conv11 form
     (4, 32, 32, 3, True, False)])
def test_conv_decomposition_matches_pallas(rng, p, ci, co, k, res, clf):
    B, H, W = 2, 16, 16 * p
    x = rng.randn(B, H, W, ci).astype(np.float32)
    w = (rng.randn(k, k, ci, co) * 0.1).astype(np.float32)
    g, b = _affine(rng, co)
    if clf:
        g = np.ones(co, np.float32)
    r = rng.randn(B, H, W, co).astype(np.float32) if res else None
    want = unpack(fused_packed_conv(
        pack(jnp.asarray(x), p), jnp.asarray(w),
        jnp.tile(jnp.asarray(g), p), jnp.tile(jnp.asarray(b), p), p=p,
        residual=pack(jnp.asarray(r), p) if res else None,
        act=not clf, pre_act=res, th=4, interpret=True), p)
    got = conv_tiled(_t(x), _t(w), _t(g), _t(b), _t(r) if res else None,
                     pre_act=res, act=not clf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("k,ci,co,p", [(7, 16, 3, 8), (3, 32, 16, 4),
                                       (1, 32, 64, 4)])
def test_input_grad_decomposition_matches_pallas_vjp(rng, k, ci, co, p):
    """The dx leg (K1 at (co, ci, k), the classifier's at (4, 16, 7))
    against pallas_conv_ad's VJP in interpret mode."""
    H, W = 16, 16 * p
    x = rng.randn(2, H, W, ci).astype(np.float32)
    w = (rng.randn(k, k, ci, co) * 0.1).astype(np.float32)
    dy = rng.randn(2, H, W, co).astype(np.float32)
    _, vjp = jax.vjp(lambda x: pallas_conv_ad(x, jnp.asarray(w), p, True),
                     pack(jnp.asarray(x), p))
    want = unpack(vjp(pack(jnp.asarray(dy), p))[0], p)
    got = input_grad_tiled(_t(dy), _t(w))
    assert got.shape == (2, H, W, ci)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


# ---- K6: the weight gradient as a GEMM over each tile's pixels


def conv_dw_tiled(x, dy, k, blocks=3, groups=1, tile=(16, 16)):
    """K6's decomposition and summation order: block b walks tiles t =
    b, b + blocks, .. (row-major over images, tile rows, tile columns);
    row group q of the block takes the tile's rows q, q + groups, ..,
    one k-step each: for each tap, x_shift[row]^T @ dy[row] over the
    row's pixels. The groups' sums are added in group order, then the
    blocks' rows in block order."""
    th, tw = tile
    bsz, h, wd, ci = x.shape
    co = dy.shape[-1]
    cop = -(-co // 8) * 8
    r, taps = k // 2, [(dy_, dx) for dy_ in range(k) for dx in range(k)]
    x, dy = x.float(), torch.nn.functional.pad(dy.float(), (0, cop - co))
    tiles_y, tiles_x = -(-h // th), -(-wd // tw)
    ntiles = bsz * tiles_y * tiles_x
    rows = []
    for blk in range(min(blocks, ntiles)):
        acc = torch.zeros(groups, len(taps), ci, cop)
        for t in range(blk, ntiles, blocks):
            n, rem = divmod(t, tiles_y * tiles_x)
            oh0, ow0 = (rem // tiles_x) * th, (rem % tiles_x) * tw
            xt = _window(x[n:n + 1], oh0 - r, ow0 - r, th + k - 1,
                         tw + k - 1)[0]
            dt = _window(dy[n:n + 1], oh0, ow0, th, tw)[0]
            for y in range(th):
                for i, (ky, kx) in enumerate(taps):
                    acc[y % groups, i] += xt[y + ky, kx:kx + tw].T @ dt[y]
        part = acc[0]
        for q in range(1, groups):
            part = part + acc[q]
        rows.append(part)
    dw = rows[0]
    for part in rows[1:]:
        dw = dw + part
    return dw[..., :co].reshape(k, k, ci, co)


@pytest.mark.parametrize("groups", [1, 2, 8])
@pytest.mark.parametrize("shape", sorted(conv.DW_SHAPES))
def test_conv_dw_decomposition_matches_plain(rng, shape, groups):
    """Every compiled (ci, co, k) at 2 x 40 x 72 (tiles cut at the border
    in both directions; the halo reads zeros outside the image), incl.
    co = 3 padded to 8, with 1, 2 and 8 row groups."""
    ci, co, k = shape
    x = _t(rng.randn(2, 40, 72, ci))
    dy = _t(rng.randn(2, 40, 72, co))
    got = conv_dw_tiled(x, dy, k, blocks=5, groups=groups)
    want = conv.conv_dw_plain(x, dy, k)
    assert got.shape == want.shape == (k, k, ci, co)
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err


def test_conv_dw_halo_reads_zeros(rng):
    """At the border the shifted x must read zeros, not the clamped or
    wrapped pixel: a decomposition that wraps differs from the plain
    version in the taps off the centre only."""
    x = _t(rng.randn(1, 16, 16, 16))
    dy = _t(rng.randn(1, 16, 16, 16))
    want = conv.conv_dw_plain(x, dy, 3)
    np.testing.assert_allclose(conv_dw_tiled(x, dy, 3).numpy(),
                               want.numpy(), atol=1e-4)
    xw = torch.roll(x, (1, 1), (1, 2))  # a wrapped halo, for tap (0, 0)
    wrong = (xw[0].reshape(-1, 16).T @ dy[0].reshape(-1, 16))
    assert float((wrong - want[0, 0]).abs().max()) > 1e-2
    np.testing.assert_allclose(want[1, 1].numpy(),
                               (x[0].reshape(-1, 16).T
                                @ dy[0].reshape(-1, 16)).numpy(), atol=1e-4)


@pytest.mark.parametrize("k,ci,co,p", [(3, 32, 16, 4), (7, 16, 3, 8),
                                       (1, 64, 32, 4), (3, 16, 32, 8)])
def test_conv_dw_decomposition_matches_pallas(rng, k, ci, co, p):
    x = rng.randn(2, 16, 16 * p, ci).astype(np.float32)
    dy = rng.randn(2, 16, 16 * p, co).astype(np.float32)
    want = pallas_conv_dw(pack(jnp.asarray(x), p), pack(jnp.asarray(dy), p),
                          p=p, kw=k, th=4, interpret=True)
    got = conv_dw_tiled(_t(x), _t(dy), k, blocks=3, groups=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-3)
