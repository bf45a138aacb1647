"""Hopper kernels of the port and their plain PyTorch versions.

K1 conv.conv_bn_act, K2 block.basic_block, K3 deconv.deconv2x and
K4 pool.maxpool3x3s2 each count their launches in ``<wrapper>.launches``.
"""
from ubresnet_tpu_torch.ops.block import basic_block  # noqa: F401
from ubresnet_tpu_torch.ops.conv import conv_bn_act  # noqa: F401
from ubresnet_tpu_torch.ops.deconv import deconv2x  # noqa: F401
from ubresnet_tpu_torch.ops.pool import maxpool3x3s2  # noqa: F401

KERNELS = {
    "conv_bn_act": conv_bn_act,
    "basic_block": basic_block,
    "deconv2x": deconv2x,
    "maxpool3x3s2": maxpool3x3s2,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
