"""The decomposition the tensor-core K2 (ops/csrc/basic_block.cu), K3
(ops/csrc/deconv2x.cu), K1 (ops/csrc/conv_bn_act.cu, conv_gemm.cuh), K6
(ops/csrc/conv_dw.cu), K5 (ops/csrc/conv_stats.cu) and K8
(ops/csrc/conv_s2k4.cu) compute, written out in plain torch on the CPU,
against the plain versions (ops/block.py:basic_block_plain,
ops/deconv.py:deconv2x_plain and conv_s2k4_plain, ops/conv.py:
conv_bn_act_plain and conv_dw_plain, ops/train_conv.py:conv_stats_plain)
and the JAX Pallas kernels in interpret mode (fused_basic_block,
fused_dual_block, fused_packed_deconv2x, fused_packed_conv,
pallas_conv_ad's VJP, pallas_conv_dw, train_conv_stats,
fused_conv_s2k4):

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
- K6: per tile of 16 rows of 16 pixels (a 16x16 image block with its x
  halo, at 1x1 a run of 256 consecutive pixels), for each x row r and
  tap row kh, x_row[r] (shifted by the tap column)^T @ dy[r - kh] (M =
  ci, K = the row's pixels, dy zeroed outside the image); at co <= 4 one
  8-column n-tile holds dy row y in columns 0-3 and row y - 1 in 4-7
  (zero outside the row group), so slot m serves tap rows 2m and 2m + 1;
  summed over each row group's rows, over the tiles t = b, b + blocks,
  .. of each block, the groups in order, the two blocks of a cluster in
  rank order, the cluster rows in sum_rows' stripe order;
- K5: K1's tile GEMM + bias, y rounded to x's dtype, and the sums of
  the rounded y of in-image pixels only, per lane (warp w, lane l: rows
  2w, 2w + 1 of each tile, columns l/4 and l/4 + 8), over the block's
  tiles, then the 8 lanes of a channel in the kernel's xor tree, the
  warps in order, the blocks' rows in sum_rows' stripe order;
- K8: each haloed dy tile (rows 2 i0 - 1 .., zero outside dy) split into
  its four (row, column) parity planes; K tap-major (tap, co); tap (kr,
  kc) reads plane (kr & 1, kc & 1) at offset (kr >> 1, kc >> 1) — the
  naive stride-2 pixel (2 ty + kr, 2 tx + kc) of the tile;
- the int8 kernels (K2-s8 ops/csrc/basic_block_s8.cu, K1-s8
  conv_bn_act_s8.cu, K3-s8 deconv2x_s8.cu): the same GEMMs in 32-deep
  k-steps with exact integer sums, two taps a k-step at 16 channels (a
  zero phantom tap padding an odd tap count), bit for bit against the
  plain versions and against the Pallas kernels' quantized modes.

float32 throughout; tolerances as tests/test_torch_kernels.py (2e-4 for
the two-conv blocks, 2e-5 for the deconv and K1) and
tests/test_torch_train_kernels.py (K6 vs Pallas rtol 1e-4, atol 1e-3;
the dx leg 1e-4 / 1e-4; K5's y 1e-5 / 1e-5 and sums 1e-4 / 1e-3) and
tests/test_torch_deconv_ad.py (K8 atol 2e-5): sums in another order. K6
against its f32 plain version: 1e-5 of the largest |dW|. K5 and K8 in
bf16 against their plain versions: y and dx within one bf16 step
(1e-2·max|plain|), the f32 sums of the bf16 y within 1e-3·max|plain|."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ubresnet_tpu.ops.packed import pack, tile_channel_vector, unpack
from ubresnet_tpu.ops.pallas_conv import (
    fused_basic_block,
    fused_conv_s2k4,
    fused_dual_block,
    fused_packed_conv,
    fused_packed_deconv2x,
    pallas_conv_ad,
    pallas_conv_dw,
    pallas_deconv_dw,
)
from ubresnet_tpu.ops.pallas_train import train_conv_stats as jax_tcs
from ubresnet_tpu_torch.ops import block, conv, deconv, quant, train_conv

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


def conv_dw_tiled(x, dy, k, clusters=3, cluster=2, groups=1, rows=16):
    """K6's decomposition and summation order: ``clusters`` x ``cluster``
    blocks; block b walks tiles t = b, b + blocks, .. (16 x 16 image
    blocks, row-major over images, tile rows, tile columns; at 1x1 runs
    of 256 consecutive pixels). Row group q of a block takes the tile's
    dy rows q R .. (q + 1) R - 1 (R = 16 / groups) and x rows q R ..
    q R + R + k - 2: for each x row r and tap row kh with dy row r - kh in
    the group, x_row[r, kw:kw + 16]^T @ dy_row[r - kh] for every tap
    column kw. At co <= 4 the dy rows are pairs [dy[y], dy[y - 1]] (zero
    outside the group), slot m = tap rows 2m, 2m + 1. The groups' sums
    are added in group order, a cluster's blocks in rank order, the
    cluster rows in sum_rows' stripe order."""
    bsz, h, wd, ci = x.shape
    co = dy.shape[-1]
    x, dy = x.float(), dy.float()
    pair = k > 1 and co <= 4
    rg, r = rows // groups, k // 2
    if k == 1:  # a run of 256 pixels is 16 rows of 16: an image of them
        npix = bsz * h * wd
        ntiles = -(-npix // (rows * 16))
        pad = ntiles * rows * 16 - npix

        def flat(a):
            a = torch.cat([a.reshape(-1, a.shape[-1]),
                           a.new_zeros(pad, a.shape[-1])])
            return a.reshape(ntiles, rows, 16, a.shape[-1])
        xt_all, dt_all = flat(x), flat(dy)
    else:
        tiles_y, tiles_x = -(-h // rows), -(-wd // 16)
        ntiles = bsz * tiles_y * tiles_x
    nblocks = clusters * cluster
    shares = []
    for blk in range(nblocks):
        acc = torch.zeros(groups, k, k, ci, co)
        for t in range(blk, ntiles, nblocks):
            if k == 1:
                xt, dt = xt_all[t], dt_all[t]
            else:
                n, rem = divmod(t, tiles_y * tiles_x)
                oh0, ow0 = (rem // tiles_x) * rows, (rem % tiles_x) * 16
                xt = _window(x[n:n + 1], oh0 - r, ow0 - r, rows + k - 1,
                             16 + k - 1)[0]
                dt = _window(dy[n:n + 1], oh0, ow0, rows, 16)[0]
            for q in range(groups):
                d = dt[q * rg:(q + 1) * rg]
                if pair:  # row y: [dy[y], dy[y - 1]], rg + 1 rows
                    z = d.new_zeros(1, 16, co)
                    d = torch.cat([torch.cat([d, z]), torch.cat([z, d])],
                                  -1)
                for xr in range(rg + k - 1):
                    xrow = xt[q * rg + xr]
                    for kw in range(k):
                        a = xrow[kw:kw + 16]
                        for m in range((k + 1) // 2 if pair else k):
                            y = xr - (2 * m if pair else m)
                            if not 0 <= y < d.shape[0]:
                                continue
                            prod = a.T @ d[y]
                            if pair:
                                acc[q, 2 * m, kw] += prod[:, :co]
                                if 2 * m + 1 < k:
                                    acc[q, 2 * m + 1, kw] += prod[:, co:]
                            else:
                                acc[q, m, kw] += prod
        share = acc[0]
        for q in range(1, groups):
            share = share + acc[q]
        shares.append(share)
    crow = []
    for c in range(clusters):
        s_ = shares[c * cluster]
        for rank in range(1, cluster):
            s_ = s_ + shares[c * cluster + rank]
        crow.append(s_)
    return _stripe_sum(crow)


@pytest.mark.parametrize("groups", [1, 2, 8])
@pytest.mark.parametrize("shape", sorted(conv.DW_SHAPES))
def test_conv_dw_decomposition_matches_plain(rng, shape, groups):
    """Every compiled (ci, co, k) at 2 x 40 x 72 (tiles cut at the border
    in both directions; the halo reads zeros outside the image; at 1x1
    the last run cut short), incl. co = 3 and 4 as tap-row pairs, with 1,
    2 and 8 row groups, 5 block pairs."""
    ci, co, k = shape
    x = _t(rng.randn(2, 40, 72, ci))
    dy = _t(rng.randn(2, 40, 72, co))
    got = conv_dw_tiled(x, dy, k, clusters=5, groups=groups)
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
    got = conv_dw_tiled(_t(x), _t(dy), k, clusters=3, groups=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-3)


# ---- K5: K1's tile GEMM with the bias, the bf16 y and its sums


def _stripe_sum(rows):
    """sum_rows' order over a block's rows: stripe q (32 of them) adds
    rows q, q + 32, .. in order, then the stripes add in order."""
    stripes = []
    for q in range(min(32, len(rows))):
        acc = rows[q]
        for r in rows[q + 32::32]:
            acc = acc + r
        stripes.append(acc)
    total = stripes[0]
    for v in stripes[1:]:
        total = total + v
    return total


def conv_stats_tiled(x, w, bias=None, blocks=3, in_image_only=True):
    """K5's decomposition and summation order. Per 16x16 output tile,
    K1's GEMM (conv_tiled) + bias, y rounded to x's dtype. Lane (w, l) of
    a block adds y and y² (f32, of the rounded y) of the in-image pixels
    at rows 2w + j (j = 0, 1) and columns l/4 + 8h (h = 0, 1), in that
    order, over the block's tiles t = b, b + blocks, ..; the 8 lanes of a
    channel then meet in the xor tree (offsets 4, 8, 16 of the lane:
    lane l/4 pairs with l/4 ^ 1, ^ 2, ^ 4), the 8 warps in order, and
    the blocks' rows in sum_rows' stripe order. ``in_image_only=False``
    also adds the pixels of the ragged tiles past the image (the GEMM
    of the zero-filled halo there)."""
    k, _, ci, co = w.shape
    bsz, h, wd, _ = x.shape
    tiles_y, tiles_x = -(-h // 16), -(-wd // 16)
    xp = torch.nn.functional.pad(x.float(), (0, 0, 0, 16 * tiles_x - wd, 0,
                                             16 * tiles_y - h))
    ones, zeros = torch.ones(co), torch.zeros(co)
    yext = conv_tiled(xp, w.float(), ones,
                      zeros if bias is None else bias.float(), act=False)
    yext = yext.to(x.dtype).float()  # the emitted values, whole tiles
    ntiles = bsz * tiles_y * tiles_x
    rows = []
    for blk in range(min(blocks, ntiles)):
        s1 = torch.zeros(8, 8, co)  # [warp, lane / 4, channel]
        s2 = torch.zeros(8, 8, co)
        for t in range(blk, ntiles, blocks):
            n, rem = divmod(t, tiles_y * tiles_x)
            oh0, ow0 = (rem // tiles_x) * 16, (rem % tiles_x) * 16
            tile = yext[n, oh0:oh0 + 16, ow0:ow0 + 16]
            if in_image_only:
                iy = torch.arange(oh0, oh0 + 16)
                ix = torch.arange(ow0, ow0 + 16)
                inside = (iy < h)[:, None] & (ix < wd)[None, :]
                tile = tile * inside[..., None]
            v = tile.reshape(8, 2, 2, 8, co)  # [warp, j, h, lane / 4, c]
            for j in range(2):
                for hh in range(2):
                    f = v[:, j, hh]
                    s1 = s1 + f
                    s2 = s2 + f * f
        for off in (1, 2, 4):  # the xor tree over lane / 4
            perm = torch.arange(8) ^ off
            s1, s2 = s1 + s1[:, perm], s2 + s2[:, perm]
        r1, r2 = s1[0, 0], s2[0, 0]
        for wp in range(1, 8):
            r1, r2 = r1 + s1[wp, 0], r2 + s2[wp, 0]
        rows.append(torch.cat([r1, r2]))
    sums = _stripe_sum(rows)
    return yext[:, :h, :wd].to(x.dtype), sums[:co], sums[co:]


def _stats_close(got, want, y_tol):
    (y, s1, s2), (py, p1, p2) = got, want
    assert y.shape == py.shape and y.dtype == py.dtype
    yerr = float((y.float() - py.float()).abs().max())
    assert yerr <= y_tol * float(py.float().abs().max()), yerr
    for g, p in ((s1, p1), (s2, p2)):
        err = float((g - p).abs().max())
        assert err <= 1e-3 * float(p.abs().max()), err


@pytest.mark.parametrize("blocks", [1, 7, 64])
@pytest.mark.parametrize("shape", sorted(train_conv.SHAPES))
def test_conv_stats_decomposition_matches_plain(rng, shape, blocks):
    """Every compiled (ci, co, k) at 2 x 40 x 72 in bf16 (16x16 tiles cut
    at both borders): y within one bf16 step, the f32 sums of the bf16 y
    within 1e-3·max|plain|, with fewer blocks than tiles (1, 7) and more
    (64: some blocks take one tile, some none)."""
    ci, co, k = shape
    x = _t(np.abs(rng.randn(2, 40, 72, ci))).to(torch.bfloat16)
    w = _t(rng.randn(k, k, ci, co) * 0.1).to(torch.bfloat16)
    b = _t(rng.randn(co) * 0.1)
    got = conv_stats_tiled(x, w, b, blocks=blocks)
    want = train_conv.conv_stats_plain(x, w, b)
    assert got[0].shape == (2, 40, 72, co)
    _stats_close(got, want, 1e-2)


def test_conv_stats_sums_in_image_pixels_only(rng):
    """Ragged tiles: the rows and columns past the image hold the GEMM
    of the zero-filled halo (the bias, plus the border's taps), and
    adding them would move the sums far beyond the tolerance."""
    x = _t(np.abs(rng.randn(1, 20, 37, 16))).to(torch.bfloat16)
    w = _t(rng.randn(3, 3, 16, 16) * 0.1).to(torch.bfloat16)
    b = _t(rng.rand(16) + 0.5)
    want = train_conv.conv_stats_plain(x, w, b)
    _stats_close(conv_stats_tiled(x, w, b), want, 1e-2)
    _, s1, _ = conv_stats_tiled(x, w, b, in_image_only=False)
    assert float((s1 - want[1]).abs().max()) > 0.1 * float(
        want[1].abs().max())


@pytest.mark.parametrize("k,ci,co,p,bias", [(3, 16, 16, 8, False),
                                            (3, 32, 16, 4, True),
                                            (7, 16, 16, 8, True),
                                            (1, 64, 32, 4, False)])
def test_conv_stats_decomposition_matches_pallas(rng, k, ci, co, p, bias):
    """float32 against train_conv_stats in interpret mode, as
    tests/test_torch_train_kernels.py runs it: y, s1 and s2."""
    x = rng.randn(2, 16, 16 * p, ci).astype(np.float32)
    w = (rng.randn(k, k, ci, co) * 0.1).astype(np.float32)
    b = rng.randn(co).astype(np.float32) if bias else None
    y_j, s1_j, s2_j = jax_tcs(pack(jnp.asarray(x), p), jnp.asarray(w),
                              jnp.asarray(b) if bias else None, p, True)
    y, s1, s2 = conv_stats_tiled(_t(x), _t(w), _t(b) if bias else None,
                                 blocks=3)
    np.testing.assert_allclose(y.numpy(), np.asarray(unpack(y_j, p)),
                               rtol=1e-5, atol=1e-5)
    for got, want in ((s1, s1_j), (s2, s2_j)):
        np.testing.assert_allclose(
            got.numpy(), np.asarray(want).reshape(p, co).sum(0), rtol=1e-4,
            atol=1e-3)


# ---- K8: the parity-plane implicit GEMM of the deconv's input gradient


def _s2k4_qh(co):
    """dx rows of K8's tile: 8 at co = 32 (dec2), 16 at co = 16 (dec1)."""
    return 8 if co >= 32 else 16


def parity_planes(dy, n, i0, j0, qh, qw=16):
    """The four (row parity, column parity) planes of dx tile (i0, j0)'s
    haloed dy window (rows 2 i0 - 1 .. 2 i0 + 2 qh, columns 2 j0 - 1 ..
    2 j0 + 2 qw, zero outside dy): planes[pr][pc] is (qh + 1, qw + 1, co)."""
    win = _window(dy[n:n + 1], 2 * i0 - 1, 2 * j0 - 1, 2 * qh + 2,
                  2 * qw + 2)[0]
    return [[win[pr::2, pc::2] for pc in range(2)] for pr in range(2)]


def conv_s2k4_tiled(dy, w, qh=None, qw=16):
    """K8's decomposition: per dx tile, A = the tile's pixels x (16 taps
    x co, tap-major), tap (kr, kc) reading plane (kr & 1, kc & 1) at
    offset (kr >> 1, kc >> 1); B[tap co + c, n] = w[kr, kc, n, c]; dx =
    A @ B rounded to dy's dtype."""
    bsz, h2, w2, co = dy.shape
    ci = w.shape[2]
    h, wd = h2 // 2, w2 // 2
    qh = _s2k4_qh(co) if qh is None else qh
    kmat = w.float().permute(0, 1, 3, 2).reshape(16 * co, ci)
    dyf = dy.float()
    out = torch.empty(bsz, h, wd, ci)
    for n in range(bsz):
        for i0 in range(0, h, qh):
            for j0 in range(0, wd, qw):
                planes = parity_planes(dyf, n, i0, j0, qh, qw)
                cols = torch.cat(
                    [planes[kr & 1][kc & 1][kr >> 1:(kr >> 1) + qh,
                                            kc >> 1:(kc >> 1) + qw]
                     for kr in range(4) for kc in range(4)], -1)
                tile = (cols.reshape(qh * qw, 16 * co) @ kmat).reshape(
                    qh, qw, ci)
                out[n, i0:i0 + qh, j0:j0 + qw] = tile[:h - i0, :wd - j0]
    return out.to(dy.dtype)


def test_s2k4_planes_are_the_stride2_pixels(rng):
    """The parity-plane index map: plane (kr & 1, kc & 1) at (ty +
    (kr >> 1), tx + (kc >> 1)) is the naive stride-2 dy pixel
    (2 (i0 + ty) + kr - 1, 2 (j0 + tx) + kc - 1), zero outside dy, for
    every dx pixel of a tile and every tap, at interior and border
    tiles."""
    dy = torch.arange(1, 1 + 2 * 20 * 36 * 2, dtype=torch.float32).reshape(
        2, 20, 36, 2)
    h, wd = 10, 18
    for n, i0, j0 in ((0, 0, 0), (1, 8, 16), (0, 8, 0)):
        planes = parity_planes(dy, n, i0, j0, 8)
        for ty in range(8):
            for tx in range(16):
                for kr in range(4):
                    for kc in range(4):
                        got = planes[kr & 1][kc & 1][ty + (kr >> 1),
                                                     tx + (kc >> 1)]
                        r = 2 * (i0 + ty) + kr - 1
                        c = 2 * (j0 + tx) + kc - 1
                        inside = (0 <= r < 2 * h and 0 <= c < 2 * wd)
                        want = dy[n, r, c] if inside else torch.zeros(2)
                        assert torch.equal(got, want), (n, i0, j0, ty, tx,
                                                        kr, kc)


@pytest.mark.parametrize("qh", [None, 8, 16], ids=["kernel", "qh8", "qh16"])
@pytest.mark.parametrize("shape", sorted(deconv.S2K4_SHAPES))
def test_conv_s2k4_decomposition_matches_plain(rng, shape, qh):
    """Every compiled (ci, co) at dx 2 x 40 x 72 (tiles cut at both
    borders) in bf16: dx within one bf16 step of the plain version; the
    kernel's tile height and both others."""
    ci, co = shape
    dy = _t(rng.randn(2, 80, 144, co)).to(torch.bfloat16)
    w = _t(rng.randn(4, 4, ci, co) * 0.1).to(torch.bfloat16)
    got = conv_s2k4_tiled(dy, w, qh)
    want = deconv.conv_s2k4_plain(dy, w)
    assert got.shape == want.shape == (2, 40, 72, ci)
    assert got.dtype == want.dtype == torch.bfloat16
    err = float((got.float() - want.float()).abs().max())
    assert err <= 1e-2 * float(want.float().abs().max()), err


@pytest.mark.parametrize("ci,co,p,h,w", [(64, 32, 4, 8, 64),
                                         (32, 16, 8, 16, 128)],
                         ids=["dec2", "dec1"])
def test_conv_s2k4_decomposition_matches_pallas(rng, ci, co, p, h, w):
    """float32 against fused_conv_s2k4 in interpret mode, fed the
    in/out-transposed kernel as tests/test_torch_deconv_ad.py feeds it."""
    wk = (rng.randn(4, 4, ci, co) * 0.1).astype(np.float32)
    dy = rng.randn(2, 2 * h, 2 * w, co).astype(np.float32)
    want = fused_conv_s2k4(pack(jnp.asarray(dy), 2 * p),
                           jnp.asarray(wk.transpose(0, 1, 3, 2)), p=p, th=4,
                           interpret=True)
    got = conv_s2k4_tiled(_t(dy), _t(wk))
    assert got.shape == (2, h, w, ci)
    np.testing.assert_allclose(got.numpy(), np.asarray(unpack(want, p)),
                               rtol=0, atol=2e-5)


# ---- K9: the deconv's weight gradient, per x tile and tap a parity-plane
# GEMM


def _dw_th(ci):
    """x rows of K9's tile: 8 at ci = 64 (dec2), 16 below."""
    return 8 if ci >= 64 else 16


def deconv_dw_tiled(x, dy, blocks=3, th=None, tw=16):
    """K9's decomposition and summation order: block b walks x tiles t =
    b, b + blocks, .. (row-major over images, tile rows, tile columns);
    per tile row y (a k-step) and tap (kr, kc), x[y]ᵀ @ the 16 pixels of
    plane (kr & 1, kc & 1) at (y + (kr >> 1), (kc >> 1) ..) added into
    the tap's dW (each tap is one warp's: within a block the order is
    tiles, then rows); then the blocks' rows in sum_rows' stripe order."""
    bsz, h, wd, ci = x.shape
    co = dy.shape[-1]
    th = _dw_th(ci) if th is None else th
    x, dyf = x.float(), dy.float()
    tiles_y, tiles_x = -(-h // th), -(-wd // tw)
    ntiles = bsz * tiles_y * tiles_x
    rows = []
    for blk in range(min(blocks, ntiles)):
        acc = torch.zeros(16, ci, co)
        for t in range(blk, ntiles, blocks):
            n, rem = divmod(t, tiles_y * tiles_x)
            i0, j0 = (rem // tiles_x) * th, (rem % tiles_x) * tw
            xt = _window(x[n:n + 1], i0, j0, th, tw)[0]
            planes = parity_planes(dyf, n, i0, j0, th, tw)
            for y in range(th):
                for tap in range(16):
                    kr, kc = tap >> 2, tap & 3
                    b = planes[kr & 1][kc & 1][y + (kr >> 1),
                                               kc >> 1:(kc >> 1) + tw]
                    acc[tap] += xt[y].T @ b
        rows.append(acc)
    return _stripe_sum(rows).reshape(4, 4, ci, co)


@pytest.mark.parametrize("th", [8, 16])
def test_deconv_dw_planes_are_the_stride2_pixels(th):
    """K9's B rows: at k-step y (x tile row y) tap (kr, kc) reads plane
    (kr & 1, kc & 1) at (y + (kr >> 1), (kc >> 1) + px), px < 16 — the
    naive stride-2 dy pixel (2 (i0 + y) + kr - 1, 2 (j0 + px) + kc - 1)
    that x pixel (i0 + y, j0 + px) meets, zero outside dy, at the
    kernel's tile heights and at interior and border tiles."""
    h, wd = 2 * th + 3, 40
    dy = torch.arange(1, 1 + 2 * h * wd * 2 * 2, dtype=torch.float32).reshape(
        1, 2 * h, 2 * wd, 2)
    for i0, j0 in ((0, 0), (th, 16), (2 * th, 32)):
        planes = parity_planes(dy, 0, i0, j0, th)
        for y in range(th):
            for kr in range(4):
                for kc in range(4):
                    got = planes[kr & 1][kc & 1][y + (kr >> 1),
                                                 kc >> 1:(kc >> 1) + 16]
                    r = 2 * (i0 + y) + kr - 1
                    cols = [2 * (j0 + px) + kc - 1 for px in range(16)]
                    want = torch.stack([
                        dy[0, r, c] if 0 <= r < 2 * h and 0 <= c < 2 * wd
                        else torch.zeros(2) for c in cols])
                    assert torch.equal(got, want), (i0, j0, y, kr, kc)


@pytest.mark.parametrize("blocks", [1, 7, 64])
@pytest.mark.parametrize("shape", sorted(deconv.DW_SHAPES))
def test_deconv_dw_decomposition_matches_plain(rng, shape, blocks):
    """Every compiled (ci, co) at x 2 x 20 x 36 (tiles cut at the border
    in both directions; the planes read zeros outside dy) with 1, 7 and
    64 blocks (more blocks than tiles at dec1): within 1e-5 of the
    largest |dW| (f32 sums in another order)."""
    ci, co = shape
    x = _t(rng.randn(2, 20, 36, ci))
    dy = _t(rng.randn(2, 40, 72, co))
    got = deconv_dw_tiled(x, dy, blocks=blocks)
    want = deconv.deconv_dw_plain(x, dy)
    assert got.shape == want.shape == (4, 4, ci, co)
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err


@pytest.mark.parametrize("ci,co,p,h,w", [(64, 32, 4, 8, 64),
                                         (32, 16, 8, 16, 128)],
                         ids=["dec2", "dec1"])
def test_deconv_dw_decomposition_matches_pallas(rng, ci, co, p, h, w):
    """float32 against pallas_deconv_dw in interpret mode, fed as
    tests/test_torch_deconv_ad.py feeds it (rtol 1e-4, atol 1e-3)."""
    x = rng.randn(2, h, w, ci).astype(np.float32)
    dy = rng.randn(2, 2 * h, 2 * w, co).astype(np.float32)
    want = pallas_deconv_dw(pack(jnp.asarray(x), p),
                            pack(jnp.asarray(dy), 2 * p), p=p, th=4,
                            interpret=True)
    got = deconv_dw_tiled(_t(x), _t(dy), blocks=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-3)


# ---- K2-s8: the int8 block as k32 implicit GEMMs with exact s32 sums


def _s8_cols(tile, oh, ow, taps, c):
    """K2-s8's A: the im2col rows of an int8 tile (K tap-major, then
    channel); at c = 16 a 32-deep k-step covers two taps, and an odd tap
    count is padded by a phantom that reads the last tap again (its
    weight rows are zero, _s8_kmat)."""
    cols = _im2col(tile, oh, ow, taps)
    if c == 16 and len(taps) % 2:
        cols = torch.cat([cols, cols[..., -16:]], -1)
    return cols.reshape(-1, cols.shape[-1])


def _s8_kmat(w, taps, c):
    """K2-s8's B: the (taps, c, co) int8 kernel read as a K x co matrix,
    with the phantom tap's 16 zero rows at c = 16 and an odd tap count."""
    k = w.reshape(taps * c, -1).long()
    if c == 16 and taps % 2:
        k = torch.cat([k, k.new_zeros(16, k.shape[1])])
    return k


def _s8_gemm(cols, kmat):
    """Σ over 32-deep k-steps of cols[:, 32 s ..] @ kmat[32 s ..] in
    int64, as the kernel's m16n8k32 steps add into s32: exact, and every
    sum must fit s32. Returned as float32, as __int2float_rn gives it."""
    assert cols.shape[1] == kmat.shape[0] and cols.shape[1] % 32 == 0
    acc = torch.zeros(cols.shape[0], kmat.shape[1], dtype=torch.int64)
    for s in range(0, cols.shape[1], 32):
        acc += cols[:, s:s + 32] @ kmat[s:s + 32]
    assert int(acc.abs().max()) < 2 ** 31
    return acc.float()


def _pad16(c):
    """tc::pad16: the channels of a kernel's tile that holds c."""
    return -(-c // 16) * 16


def _zpad(t, *sizes):
    """t zero-padded at the high end of its last len(sizes) axes to
    ``sizes``."""
    pads = []
    for d, n in zip(reversed(range(t.dim() - len(sizes), t.dim())),
                    reversed(sizes)):
        pads += [0, n - t.shape[d]]
    return F.pad(t, pads)


def block_s8_tiled(aq, bq, w1q, g1, b1, w2q, g2, b2, wbq, gb, bb,
                   out_dtype=torch.float32, tile=(16, 16)):
    """K2-s8's decomposition: per 16x16 output tile, conv1 as the k32
    GEMM over the tile's 18x18 m pixels (x window zero outside the
    image), its epilogue requantized to int8 and zero outside the image,
    conv2 and the 1x1 bypass as k32 GEMMs over the tile, the f32
    epilogue in the plain version's steps (quant.fma, relu, add, relu).
    8-channel streams run as the kernel runs them: x, m, the weights and
    the affines zero-padded to 16 channels (basic_block_s8.cu), the
    padded channels dropped at the end. Returns the output and the
    tiles' m at the image's pixels."""
    th, tw = tile
    x = (aq if bq is None else torch.cat([aq, bq], -1)).long()
    co_real = w1q.shape[-1]
    cin, co = _pad16(x.shape[-1]), _pad16(co_real)
    if (cin, co) != (x.shape[-1], co_real):
        x = _zpad(x, cin)
        w1q, w2q = _zpad(w1q, cin, co), _zpad(w2q, co, co)
        wbq = None if wbq is None else _zpad(wbq, cin, co)
        g1, b1, g2, b2, gb, bb = (_zpad(v, co)
                                  for v in (g1, b1, g2, b2, gb, bb))
        out, mid = block_s8_tiled(x.to(torch.int8), None, w1q, g1, b1, w2q,
                                  g2, b2, wbq, gb, bb, out_dtype, tile)
        return out[..., :co_real], mid[..., :co_real]
    bsz, h, w, _ = x.shape
    k1, k2 = _s8_kmat(w1q, 9, cin), _s8_kmat(w2q, 9, co)
    kb = None if wbq is None else _s8_kmat(wbq, 1, cin)
    fma = quant.fma
    out = torch.empty(bsz, h, w, co, dtype=out_dtype)
    mid = torch.empty(bsz, h, w, co, dtype=torch.int8)
    for oh0 in range(0, h, th):
        for ow0 in range(0, w, tw):
            xt = _window(x, oh0 - 2, ow0 - 2, th + 4, tw + 4)
            y1 = torch.relu(fma(_s8_gemm(_s8_cols(xt, th + 2, tw + 2, TAPS3,
                                                  cin), k1), g1, b1))
            m = torch.round(torch.clamp(y1, max=quant.INT8_MAX))
            iy = torch.arange(oh0 - 1, oh0 + th + 1)
            ix = torch.arange(ow0 - 1, ow0 + tw + 1)
            inside = (((iy >= 0) & (iy < h))[:, None]
                      & ((ix >= 0) & (ix < w))[None, :]).reshape(-1, 1)
            m = (m.reshape(bsz, -1, co) * inside).to(torch.int8).reshape(
                bsz, th + 2, tw + 2, co)
            ny, nx = min(th, h - oh0), min(tw, w - ow0)
            mid[:, oh0:oh0 + ny, ow0:ow0 + nx] = m[:, 1:1 + ny, 1:1 + nx]
            y = torch.relu(fma(_s8_gemm(_s8_cols(m.long(), th, tw, TAPS3, co),
                                        k2), g2, b2))
            centre = xt[:, 2:2 + th, 2:2 + tw]
            if kb is None:
                r = fma(centre.reshape(-1, cin).float(), gb, bb)
            else:
                r = fma(_s8_gemm(_s8_cols(centre, th, tw, [(0, 0)], cin), kb),
                        gb, bb)
            o = torch.relu(y + r).to(out_dtype).reshape(bsz, th, tw, co)
            out[:, oh0:oh0 + ny, ow0:ow0 + nx] = o[:, :ny, :nx]
    return out, mid


def _s8(rng, shape, lim=127):
    return torch.from_numpy(rng.randint(-lim, lim + 1, shape).astype(np.int8))


def _s8_block_inputs(rng, bsz, h, w, ca, cb, co, proj):
    """int8 inputs (post-ReLU 0..127) and weights, g1 scaled so the
    requantized m spans the int8 grid and saturates at 127."""
    cin = ca + cb
    a = _s8(rng, (bsz, h, w, ca)).abs()
    b = _s8(rng, (bsz, h, w, cb)).abs() if cb else None
    g = [_t(np.abs(rng.randn(co)) * s) for s in (0.028 / np.sqrt(9 * cin),
                                                 1e-3, 1e-3)]
    be = [_t(rng.randn(co) * 3) for _ in range(3)]
    if not proj:
        g[2], be[2] = torch.full((co,), 0.05), torch.zeros(co)
    return (a, b, _s8(rng, (3, 3, cin, co), 64), g[0], be[0],
            _s8(rng, (3, 3, co, co), 64), g[1], be[1],
            _s8(rng, (cin, co), 64) if proj else None, g[2], be[2])


def test_s8_two_taps_a_step_k_order(rng):
    """cin = 16: K row 32 s + kk is tap 2 s + kk // 16, channel kk % 16,
    and the phantom tenth tap (rows 144-159) reads tap 8's pixels with
    zero weight rows — a nonzero row there would change the sums."""
    x = _s8(rng, (1, 20, 20, 16)).long()
    cols = _s8_cols(x, 18, 18, TAPS3, 16)
    assert cols.shape == (324, 160)
    for kp in (0, 17, 31, 32 * 3 + 20, 32 * 4 + 5, 32 * 4 + 21):
        tap, c = kp // 16, kp % 16
        dy, dx = TAPS3[min(tap, 8)]
        ref = x[0, dy:dy + 18, dx:dx + 18, c].reshape(-1)
        assert torch.equal(cols[:, kp], ref)
    w = _s8(rng, (3, 3, 16, 32))
    kmat = _s8_kmat(w, 9, 16)
    assert torch.equal(kmat[:144], w.reshape(144, 32).long())
    assert int(kmat[144:].abs().max()) == 0
    bad = kmat.clone()
    bad[150] = 1
    assert not torch.equal(_s8_gemm(cols, bad), _s8_gemm(cols, kmat))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", sorted(block.S8_SHAPES))
def test_block_s8_decomposition_matches_plain(rng, shape, out_dtype):
    """Every compiled (ca, cb, co, proj) at 2 x 20 x 37 (16x16 tiles cut
    at the border): the output bit for bit the plain version's, and m
    too — exact s32 sums in any order, the same f32 epilogue steps."""
    ca, cb, co, proj = shape
    args = _s8_block_inputs(rng, 2, 20, 37, ca, cb, co, proj)
    got, m = block_s8_tiled(*args, out_dtype=out_dtype)
    want, want_m = block.basic_block_s8_plain(*args, out_dtype=out_dtype,
                                              with_mid=True)
    assert got.dtype == want.dtype == out_dtype
    assert torch.equal(m, want_m)
    assert int(want_m.max()) == 127 and int(want_m.min()) == 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", sorted(block.S8_SHAPES))
def test_block_s8_decomposition_matches_pallas(shape):
    """float32 against fused_basic_block / fused_dual_block with
    quantized=True in interpret mode, fed as
    tests/test_torch_int8_kernels.py feeds them (rtol 1e-6, atol 1e-4)."""
    ca, cb, co, proj = shape
    p = 128 // ca
    rng = np.random.RandomState(7 + ca + cb + co)
    args = _s8_block_inputs(rng, 2, 16, 4 * p, ca, cb, co, proj)
    a, b, w1, g1, b1, w2, g2, b2, wb, gb, bb = args
    j, tcv = jnp.asarray, tile_channel_vector
    aff = [tcv(j(v.numpy()), p) for v in (g1, b1, g2, b2, gb, bb)]
    if cb:
        want = fused_dual_block(
            pack(j(a.numpy()), p), pack(j(b.numpy()), p), j(w1.numpy()),
            aff[0], aff[1], j(w2.numpy()), aff[2], aff[3],
            j(wb.numpy()[None, None]), aff[4], aff[5], p=p,
            out_dtype=jnp.float32, interpret=True)
    else:
        want = fused_basic_block(
            pack(j(a.numpy()), p), j(w1.numpy()), aff[0], aff[1],
            j(w2.numpy()), aff[2], aff[3],
            j(wb.numpy()[None, None]) if proj else None, aff[4], aff[5],
            p=p, out_dtype=jnp.float32, interpret=True)
    got, _ = block_s8_tiled(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(unpack(want, p)),
                               rtol=1e-6, atol=1e-4)


# ---- K1-s8: K1's implicit GEMM on m16n8k32 (conv_gemm.cuh, T = int8_t)


def conv_s8_tiled(xq, wq, g, b, residual=None, pre_act=False, act=True,
                  out_dtype=torch.float32, tile=(16, 16)):
    """K1-s8's decomposition: per 16x16 output tile, the haloed int8 x
    tile (zero outside the image) as im2col rows over the 49 taps, K
    tap-major and two taps a 32-deep k-step at 16 channels, the phantom
    50th tap reading tap 48's pixels with zero weight rows (_s8_cols,
    _s8_kmat), the k32 GEMM with exact sums, then the f32 epilogue in the
    plain version's steps (quant.fma, relu, add, relu)."""
    th, tw = tile
    k, _, ci, co = wq.shape
    if ci == 8 or co % 8:
        # an 8-byte pixel in a 16-byte tile pixel, N padded to 8: zeros
        # (conv_bn_act_s8.cu)
        cop = -(-co // 8) * 8
        out = conv_s8_tiled(
            _zpad(xq, 16 if ci == 8 else ci),
            _zpad(wq, 16 if ci == 8 else ci, cop), _zpad(g, cop),
            _zpad(b, cop),
            None if residual is None else _zpad(residual, cop), pre_act,
            act, out_dtype, tile)
        return out[..., :co].contiguous()
    r = k // 2
    taps = [(dy, dx) for dy in range(k) for dx in range(k)]
    kmat = _s8_kmat(wq, k * k, ci)
    x = xq.long()
    bsz, h, w, _ = x.shape
    out = torch.empty(bsz, h, w, co, dtype=out_dtype)
    for oh0 in range(0, h, th):
        for ow0 in range(0, w, tw):
            xt = _window(x, oh0 - r, ow0 - r, th + k - 1, tw + k - 1)
            y = quant.fma(_s8_gemm(_s8_cols(xt, th, tw, taps, ci), kmat),
                          g, b)
            if pre_act:
                y = torch.relu(y)
            if residual is not None:
                y = y + _window(residual.float(), oh0, ow0, th,
                                tw).reshape(-1, co)
            if act:
                y = torch.relu(y)
            o = y.to(out_dtype).reshape(bsz, th, tw, co)
            ny, nx = min(th, h - oh0), min(tw, w - ow0)
            out[:, oh0:oh0 + ny, ow0:ow0 + nx] = o[:, :ny, :nx]
    return out


def _s8_conv_inputs(rng, bsz, h, w, ci, co, k):
    """int8 x and weights over the whole grid, g spreading y over a few
    units around b, a float residual."""
    return (_s8(rng, (bsz, h, w, ci)), _s8(rng, (k, k, ci, co)),
            _t(np.abs(rng.randn(co)) * 1e-4), _t(rng.randn(co) * 3),
            _t(rng.randn(bsz, h, w, co) * 4))


S8_OUT = [torch.float32, torch.bfloat16]
TAPS7 = [(dy, dx) for dy in range(7) for dx in range(7)]


@pytest.mark.parametrize("out_dtype", S8_OUT, ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", CONV_MODES, ids=CONV_IDS)
def test_conv_s8_decomposition_matches_plain(rng, mode, out_dtype):
    """The flagship's (16, 16, 7) at 2 x 20 x 37 (16x16 tiles cut at the
    border), each epilogue and output dtype: bit for bit the plain
    version's — exact s32 sums, the same f32 epilogue steps."""
    ci, co, k = 16, 16, 7
    assert (ci, co, k) in conv.S8_SHAPES
    res, pre, act = mode
    x, w, g, b, r = _s8_conv_inputs(rng, 2, 20, 37, ci, co, k)
    r = r.to(out_dtype) if res else None
    got = conv_s8_tiled(x, w, g, b, r, pre, act, out_dtype)
    want = conv.conv_bn_act_s8_plain(x, w, g, b, r, pre_act=pre, act=act,
                                     out_dtype=out_dtype)
    assert got.dtype == want.dtype == out_dtype
    assert got.shape == want.shape == (2, 20, 37, co)
    assert torch.equal(got, want)
    if act:
        assert 0 < int((want > 0).sum()) < want.numel()


def test_conv_s8_two_taps_a_step_k_order(rng):
    """ci = 16 at 7x7: K row 32 s + kk is tap 2 s + kk // 16, channel
    kk % 16, the 49 taps padded by a phantom 50th (rows 784-799) that
    reads tap 48's pixels with zero weight rows. A nonzero phantom row,
    or the weight read channel-major instead of tap-major, changes the
    sums."""
    x = _s8(rng, (1, 22, 22, 16)).long()
    cols = _s8_cols(x, 16, 16, TAPS7, 16)
    assert cols.shape == (256, 800)
    for kp in (0, 15, 16, 31, 32 * 12 + 7, 32 * 24 + 15, 32 * 24 + 16,
               32 * 24 + 31):
        tap, c = kp // 16, kp % 16
        dy, dx = TAPS7[min(tap, 48)]
        assert torch.equal(cols[:, kp], x[0, dy:dy + 16, dx:dx + 16,
                                          c].reshape(-1))
    w = _s8(rng, (7, 7, 16, 16))
    kmat = _s8_kmat(w, 49, 16)
    assert kmat.shape == (800, 16)
    assert torch.equal(kmat[:784], w.reshape(784, 16).long())
    assert int(kmat[784:].abs().max()) == 0
    want = _s8_gemm(cols, kmat)
    valid = quant.int_conv2d(x.to(torch.int8), w, 0)  # the tile's 16x16
    assert torch.equal(want, valid.reshape(256, 16))
    bad = kmat.clone()
    bad[790] = 1
    assert not torch.equal(_s8_gemm(cols, bad), want)
    channel_major = w.permute(2, 0, 1, 3).reshape(784, 16).long()
    wrong = torch.cat([channel_major, kmat[784:]])
    assert not torch.equal(_s8_gemm(cols, wrong), want)


@pytest.mark.parametrize("mode", ["act", "pre_act_residual", "no_act"])
def test_conv_s8_decomposition_matches_pallas(mode):
    """float32 against fused_packed_conv with quantized int8 inputs in
    interpret mode, fed as tests/test_torch_int8_kernels.py feeds it
    (rtol 1e-6, atol 1e-5)."""
    ci, co, k = 16, 16, 7
    p = 128 // ci
    rng = np.random.RandomState(3)
    x, w = _s8(rng, (2, 16, 4 * p, ci)), _s8(rng, (k, k, ci, co))
    g = (rng.randn(co) * 0.01).astype(np.float32)
    b = rng.randn(co).astype(np.float32)
    res = rng.randn(2, 16, 4 * p, co).astype(np.float32)
    pre_act, act = mode == "pre_act_residual", mode != "no_act"
    j = jnp.asarray
    want = unpack(fused_packed_conv(
        pack(j(x.numpy()), p), j(w.numpy()), jnp.tile(j(g), p),
        jnp.tile(j(b), p), p=p,
        residual=pack(j(res), p) if pre_act else None, pre_act=pre_act,
        act=act, out_dtype=jnp.float32, interpret=True), p)
    got = conv_s8_tiled(x, w, _t(g), _t(b), _t(res) if pre_act else None,
                        pre_act, act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)


S8_CONVS_8 = sorted(s for s in conv.S8_SHAPES if s[0] == 8)


@pytest.mark.parametrize("out_dtype", S8_OUT, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", S8_CONVS_8, ids=map(str, S8_CONVS_8))
def test_conv_s8_decomposition_8_channels(rng, shape, out_dtype):
    """The 8-channel K1-s8 instances (the inplanes-8 head, the inplanes-4
    per-conv blocks' convs) as the kernel pads them — 8-byte pixels in
    16-byte tile pixels, two taps and a zero phantom a k-step, co = 4 in
    a zero-padded n-tile — at 2 x 20 x 37 with a residual: bit for bit
    the plain version's. A nonzero padded channel would change them."""
    ci, co, k = shape
    x, w, g, b, r = _s8_conv_inputs(rng, 2, 20, 37, ci, co, k)
    r = r.to(out_dtype)
    got = conv_s8_tiled(x, w, g, b, r, True, True, out_dtype)
    want = conv.conv_bn_act_s8_plain(x, w, g, b, r, pre_act=True, act=True,
                                     out_dtype=out_dtype)
    assert got.shape == want.shape == (2, 20, 37, co)
    assert torch.equal(got, want)
    bad = torch.cat([x, torch.ones_like(x)], -1)
    wp = _zpad(w, 16, co)
    wp[:, :, 8:] = 1
    assert not torch.equal(
        conv_s8_tiled(bad, wp, g, b, r, True, True, out_dtype), want)


# ---- K3-s8: K3's four parity GEMMs on m16n8k32


def deconv_s8_tiled(xq, wq, g, out_dtype=torch.float32, tile=(16, 16),
                    taps_of=None):
    """K3-s8's decomposition: per 16x16 input tile, one 18x18 haloed
    int8 tile (zero outside the image) serves all four parity classes,
    each the k32 GEMM [pixels x 4 ci] @ [4 ci x co] with K tap-major over
    the class's taps s = 2 sr + sc (deconv2x_s8.cu:tap_k / tap_di, here
    _tap) and exact sums, then times g in float32 (one rounding),
    interleaved into the 2x output. ``taps_of(pa, pb, s)`` overrides the
    (kh, di, kw, dj) of tap s of class (pa, pb)."""
    qh, qw = tile
    x = xq.long()
    bsz, h, wd, ci = x.shape
    co = wq.shape[-1]
    taps_of = taps_of or (lambda pa, pb, s: (*_tap(pa, s // 2),
                                             *_tap(pb, s % 2)))
    out = torch.empty(bsz, 2 * h, 2 * wd, co, dtype=out_dtype)
    for qy0 in range(0, h, qh):
        for qx0 in range(0, wd, qw):
            xt = _window(x, qy0 - 1, qx0 - 1, qh + 2, qw + 2)
            ny, nx = min(qh, h - qy0), min(qw, wd - qx0)
            for pa in range(2):
                for pb in range(2):
                    taps, kmat = [], []
                    for s in range(4):
                        kh, di, kw, dj = taps_of(pa, pb, s)
                        taps.append((1 + di, 1 + dj))
                        kmat.append(wq[kh, kw].long())
                    acc = _s8_gemm(_s8_cols(xt, qh, qw, taps, ci),
                                   torch.cat(kmat, 0))
                    y = (acc * g).to(out_dtype).reshape(bsz, qh, qw, co)
                    out[:, 2 * qy0 + pa:2 * (qy0 + ny):2,
                        2 * qx0 + pb:2 * (qx0 + nx):2] = y[:, :ny, :nx]
    return out


@pytest.mark.parametrize("out_dtype", S8_OUT, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", sorted(deconv.S8_SHAPES))
def test_deconv_s8_decomposition_matches_plain(rng, shape, out_dtype):
    """Every compiled (ci, co) at 2 x 19 x 35 (16x16 input tiles cut at
    the border): bit for bit the plain version's."""
    ci, co = shape
    x, w = _s8(rng, (2, 19, 35, ci)), _s8(rng, (4, 4, ci, co))
    g = _t(np.abs(rng.randn(co)) * 1e-3)
    got = deconv_s8_tiled(x, w, g, out_dtype)
    want = deconv.deconv2x_s8_plain(x, w, g, out_dtype)
    assert got.dtype == want.dtype == out_dtype
    assert got.shape == want.shape == (2, 38, 70, co)
    assert torch.equal(got, want)


def test_deconv_s8_parity_taps(rng):
    """Each class reads its 4 taps inside the one 18x18 haloed tile
    (offsets 0..2), and the class-to-tap map matters: the row and column
    parities swapped, or a class's taps in another K order than its B
    rows, change the output."""
    for pa in range(2):
        for pb in range(2):
            for s in range(4):
                _, di = _tap(pa, s // 2)
                _, dj = _tap(pb, s % 2)
                assert 0 <= 1 + di <= 2 and 0 <= 1 + dj <= 2
    x, w = _s8(rng, (1, 16, 16, 32)), _s8(rng, (4, 4, 32, 16))
    g = torch.ones(16)
    want = deconv.deconv2x_s8_plain(x, w, g, torch.float32)
    assert torch.equal(deconv_s8_tiled(x, w, g), want)
    swapped = deconv_s8_tiled(x, w, g, taps_of=lambda pa, pb, s: (
        *_tap(pb, s // 2), *_tap(pa, s % 2)))
    assert not torch.equal(swapped, want)

    def b_rows_out_of_order(pa, pb, s):  # A's tap s, B's tap 3 - s
        kh, di, kw, dj = (*_tap(pa, s // 2), *_tap(pb, s % 2))
        kh2, _, kw2, _ = (*_tap(pa, (3 - s) // 2), *_tap(pb, (3 - s) % 2))
        return kh2, di, kw2, dj
    assert not torch.equal(
        deconv_s8_tiled(x, w, g, taps_of=b_rows_out_of_order), want)


@pytest.mark.parametrize("shape", sorted(deconv.S8_SHAPES))
def test_deconv_s8_decomposition_matches_pallas(shape):
    """float32 against fused_packed_deconv2x with quantized int8 inputs
    in interpret mode, fed as tests/test_torch_int8_kernels.py feeds it
    (rtol 1e-6, atol 1e-5)."""
    ci, co = shape
    p = 128 // ci
    rng = np.random.RandomState(8 + ci)
    x, w = _s8(rng, (2, 8, 4 * p, ci)), _s8(rng, (4, 4, ci, co), 64)
    g = (np.abs(rng.randn(co)) * 1e-3).astype(np.float32)
    want = unpack(fused_packed_deconv2x(
        pack(jnp.asarray(x.numpy()), p), jnp.asarray(w.numpy()),
        tile_channel_vector(jnp.asarray(g), 2 * p), p=p,
        out_dtype=jnp.float32, interpret=True), p)
    got = deconv_s8_tiled(x, w, _t(g))
    assert got.shape == want.shape == (2, 16, 8 * p, co)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)
