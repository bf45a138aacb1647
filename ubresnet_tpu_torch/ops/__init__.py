"""Hopper kernels of the port and their plain PyTorch versions.

Eval: K1 conv.conv_bn_act, K2 block.basic_block, K3 deconv.deconv2x,
K4 pool.maxpool3x3s2. Train: K5 train_conv.conv_stats, K6
conv.conv_dw, K7 loss.weighted_nll_fwd / weighted_nll_bwd; K1 also
runs the train zone's input gradients and K4 the stem pool's forward.
Train with Policy.fused_train_deconv: K3 runs the decoder upsamples
forward and K10 deconv.deconv2x_bwd their input and weight gradients in
one launch (deconv.deconv2x_ad); K8 deconv.conv_s2k4 and K9
deconv.deconv_dw compute one leg each.
int8 deploy: K1-s8 conv.conv_bn_act_s8, K2-s8 block.basic_block_s8,
K3-s8 deconv.deconv2x_s8 (PTQ pieces in quant). Each wrapper counts
its launches in ``<wrapper>.launches`` (a CUDA graph's replay adds its
capture's, ``add_launch_counts``).
"""
from ubresnet_tpu_torch.ops.block import (  # noqa: F401
    basic_block,
    basic_block_s8,
)
from ubresnet_tpu_torch.ops.conv import (  # noqa: F401
    conv_bn_act,
    conv_bn_act_s8,
    conv_dw,
)
from ubresnet_tpu_torch.ops.deconv import (  # noqa: F401
    conv_s2k4,
    deconv2x,
    deconv2x_bwd,
    deconv2x_s8,
    deconv_dw,
)
from ubresnet_tpu_torch.ops.loss import (  # noqa: F401
    weighted_nll_bwd,
    weighted_nll_fwd,
)
from ubresnet_tpu_torch.ops.pool import maxpool3x3s2  # noqa: F401
from ubresnet_tpu_torch.ops.train_conv import conv_stats  # noqa: F401

KERNELS = {
    "conv_bn_act": conv_bn_act,
    "basic_block": basic_block,
    "deconv2x": deconv2x,
    "maxpool3x3s2": maxpool3x3s2,
    "conv_stats": conv_stats,
    "conv_dw": conv_dw,
    "weighted_nll": weighted_nll_fwd,
    "weighted_nll_bwd": weighted_nll_bwd,
    "conv_bn_act_s8": conv_bn_act_s8,
    "basic_block_s8": basic_block_s8,
    "deconv2x_s8": deconv2x_s8,
    "conv_s2k4": conv_s2k4,
    "deconv_dw": deconv_dw,
    "deconv2x_bwd": deconv2x_bwd,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def add_launch_counts(counts: dict) -> None:
    """Count the launches of a CUDA graph's replay: ``counts``, what its
    capture counted once."""
    for name, n in counts.items():
        KERNELS[name].launches += n
