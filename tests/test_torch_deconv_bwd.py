"""K10 (ubresnet_tpu_torch/ops/deconv.py:deconv2x_bwd, csrc/deconv2x_bwd.cu),
the deconv's backward in one launch, on the CPU:

  * its plain version (the CPU path, dx and dW together) against JAX's
    _deconv_ad_bwd — fused_conv_s2k4 and pallas_deconv_dw in interpret
    mode on W-packed tensors — at the flagship (ci, co) and the
    8-channel streams', float32, with tests/test_torch_deconv_ad.py's
    tolerances for the two legs: dx atol 2e-5, dW rtol 1e-4 / atol 1e-3;
  * the kernel's decomposition and summation order written out in plain
    torch: one walk over x-side tiles (8x16 at (64, 32), 16x16 below)
    whose x tile and dy parity planes give both dx (K8's GEMM) and the
    block's dW share (K9's GEMMs, tiles then rows); the shares added
    rank by rank in clusters of 8 blocks, the clusters' rows in order.
    At 1, 7 and 64 clusters (more blocks than tiles), against the plain
    version: dx and dW within 1e-5 of their largest magnitude (f32 sums
    in another order), as K9's stripe-order test;
  * the wrapper's CPU route: the plain version, the launch count
    untouched, and deconv2x_ad's backward through it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ubresnet_tpu.ops.packed import pack, unpack
from ubresnet_tpu.ops.pallas_conv import _deconv_ad_bwd
from test_torch_tiled_decomp import _window, parity_planes
from ubresnet_tpu_torch.ops import deconv

torch.set_num_threads(1)

# (ci, co, p, H, W) as tests/test_torch_deconv_ad.py: the flagship's dec2
# and dec1 and the 8-channel streams' (16, 8) and (8, 4) at their packs
FLAGSHIP = [(64, 32, 4, 8, 64), (32, 16, 8, 16, 128)]
EIGHT = [(16, 8, 8, 16, 128), (8, 4, 16, 16, 256)]
IDS = ["dec2", "dec1", "c16-8", "c8-4"]
CLUSTER = 8  # blocks a K10 cluster


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("ci,co,p,h,w", FLAGSHIP + EIGHT, ids=IDS)
def test_bwd_plain_matches_jax_deconv_ad_bwd(rng, ci, co, p, h, w):
    x = rng.randn(2, h, w, ci).astype(np.float32)
    wk = (rng.randn(4, 4, ci, co) * 0.1).astype(np.float32)
    dy = rng.randn(2, 2 * h, 2 * w, co).astype(np.float32)
    dx_j, dw_j = _deconv_ad_bwd(p, True, (pack(jnp.asarray(x), p),
                                          jnp.asarray(wk)),
                                pack(jnp.asarray(dy), p))
    dx, dw = deconv.deconv2x_bwd_plain(_t(x), _t(dy), _t(wk))
    assert dx.shape == (2, h, w, ci) and dx.dtype == torch.float32
    assert dw.shape == (4, 4, ci, co) and dw.dtype == torch.float32
    np.testing.assert_allclose(dx.numpy(), np.asarray(unpack(dx_j, p)),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_j), rtol=1e-4,
                               atol=1e-3)


def _tile_rows(ci, co):
    """x-side rows of K10's tile (parity_tiles.cuh:tile_rows)."""
    return 8 if ci * co >= 64 * 32 else 16


def deconv2x_bwd_tiled(x, dy, w, clusters, qw=16):
    """K10's decomposition and order. Block b of the clusters x 8 walks
    x-side tiles t = b, b + blocks, ..; per tile the x tile and dy's
    parity planes give dx (A = the tile's pixels x (16 taps x co), tap
    (kr, kc) reading plane (kr & 1, kc & 1) at offset (kr >> 1, kc >>
    1)) and, per tile row y and tap, x[y]ᵀ @ the plane's 16 pixels added
    into the block's dW share. A cluster's rank r adds slice r of its 8
    blocks' shares in rank order into the cluster's row; the last
    cluster adds the rows in cluster order."""
    bsz, h, wd, ci = x.shape
    co = dy.shape[-1]
    qh = _tile_rows(ci, co)
    kmat = w.permute(0, 1, 3, 2).reshape(16 * co, ci)
    tiles_x = -(-wd // qw)
    per_img = tiles_x * -(-h // qh)
    ntiles, blocks = bsz * per_img, clusters * CLUSTER
    dx = torch.zeros(bsz, h, wd, ci)
    shares = []
    for blk in range(blocks):
        acc = torch.zeros(16, ci, co)
        for t in range(blk, ntiles, blocks):
            n, rem = divmod(t, per_img)
            i0, j0 = (rem // tiles_x) * qh, (rem % tiles_x) * qw
            xt = _window(x[n:n + 1], i0, j0, qh, qw)[0]
            planes = parity_planes(dy, n, i0, j0, qh, qw)
            taps = [planes[kr & 1][kc & 1][kr >> 1:(kr >> 1) + qh,
                                           kc >> 1:(kc >> 1) + qw]
                    for kr in range(4) for kc in range(4)]
            tile = (torch.cat(taps, -1).reshape(qh * qw, 16 * co)
                    @ kmat).reshape(qh, qw, ci)
            dx[n, i0:i0 + qh, j0:j0 + qw] = tile[:h - i0, :wd - j0]
            for y in range(qh):
                for tap in range(16):
                    acc[tap] += xt[y].T @ taps[tap][y]
        shares.append(acc.reshape(-1))
    rows = []
    for c in range(clusters):
        row = shares[c * CLUSTER]
        for r in range(1, CLUSTER):
            row = row + shares[c * CLUSTER + r]
        rows.append(row)
    dw = rows[0]
    for row in rows[1:]:
        dw = dw + row
    return dx, dw.reshape(4, 4, ci, co)


@pytest.mark.parametrize("clusters", [1, 7, 64])
@pytest.mark.parametrize("shape", sorted(deconv.BWD_SHAPES))
def test_bwd_decomposition_matches_plain(rng, shape, clusters):
    """Every compiled (ci, co) at x 2 x 20 x 36 (tiles cut at the border
    in both directions; the planes read zeros outside dy)."""
    ci, co = shape
    x = _t(rng.randn(2, 20, 36, ci))
    dy = _t(rng.randn(2, 40, 72, co))
    w = _t(rng.randn(4, 4, ci, co) * 0.1)
    dx, dw = deconv2x_bwd_tiled(x, dy, w, clusters)
    pdx, pdw = deconv.deconv2x_bwd_plain(x, dy, w)
    assert dx.shape == pdx.shape and dw.shape == pdw.shape == (4, 4, ci, co)
    assert float((dx - pdx).abs().max()) <= 1e-5 * float(pdx.abs().max())
    err = float((dw - pdw).abs().max())
    assert err <= 1e-5 * float(pdw.abs().max()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_bwd_wrapper_on_the_cpu_is_the_plain_version(rng, dtype):
    """A CPU tensor takes the plain version (no launch counted): dx in
    dy's dtype, dW float32, bit-equal to the two legs' plain versions;
    deconv2x_ad's backward is it, dx cast to x's dtype and dW rounded to
    w's."""
    x = _t(rng.randn(2, 6, 10, 32)).to(dtype)
    w = _t(rng.randn(4, 4, 32, 16) * 0.1).to(dtype)
    dy = _t(rng.randn(2, 12, 20, 16)).to(dtype)
    before = deconv.deconv2x_bwd.launches
    dx, dw = deconv.deconv2x_bwd(x, dy, w)
    assert deconv.deconv2x_bwd.launches == before
    assert dx.dtype == dtype and dw.dtype == torch.float32
    assert torch.equal(dx, deconv.conv_s2k4_plain(dy, w))
    assert torch.equal(dw, deconv.deconv_dw_plain(x, dy))
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    gx, gw = torch.autograd.grad(deconv.deconv2x_ad(xr, wr), (xr, wr), dy)
    assert gx.dtype == gw.dtype == dtype
    assert torch.equal(gx, dx) and torch.equal(gw, dw.to(dtype))


def test_deconv2x_ad_takes_strided_inputs(rng):
    """The autograd Function lays out a strided x, w and dy itself (the
    kernels take contiguous tensors): the same values as from contiguous
    copies, and as F.conv_transpose2d's autograd in float64."""
    x = _t(rng.randn(2, 10, 6, 32)).transpose(1, 2)  # (2, 6, 10, 32) view
    w = _t(rng.randn(32, 16, 4, 4) * 0.1).permute(2, 3, 0, 1)
    dy = _t(rng.randn(2, 20, 12, 16)).transpose(1, 2)
    assert not (x.is_contiguous() or w.is_contiguous()
                or dy.is_contiguous())
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = deconv.deconv2x_ad(xr, wr)
    gx, gw = torch.autograd.grad(y, (xr, wr), dy)
    xd = x.double().requires_grad_()
    wd = w.double().requires_grad_()
    yd = F.conv_transpose2d(xd.permute(0, 3, 1, 2), wd.permute(2, 3, 0, 1),
                            stride=2, padding=1).permute(0, 2, 3, 1)
    want = (yd, *torch.autograd.grad(yd, (xd, wd), dy.double()))
    for got, ref in zip((y.detach(), gx, gw), want):
        ref = ref.detach()
        assert got.shape == ref.shape
        err = float((got.double() - ref).abs().max())
        assert err <= 2e-5 * float(ref.abs().max()), err
