"""Mixed-precision policy (counterpart of ubresnet_tpu/core/precision.py).

Parameters and BatchNorm statistics are read and folded in float32;
convolutions run in bfloat16 by default and the network head is
float32 so the log-softmax is stable. ``Policy.f32()`` is the full-float32 parity
mode: it also turns the kernel zones off, so every layer runs as a
float32 torch.nn.functional op (with TF32 off on the card, see
utils/platform.py:strict_f32).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """compute_dtype: dtype activations and conv weights run in.
    output_dtype:  dtype of the classifier output before log-softmax.
    fused_eval:    route the kernel-zone layers (stem pool, enc1,
                   dec2, dec1, head, classifier) through the Hopper
                   kernels of ops/ wherever their shape qualifies. The
                   kernels take bfloat16 only; on the CPU the wrappers
                   run their plain versions in any dtype.
    fused_train:   the same for the train-mode model: the train zone's
                   stride-1 convs (enc1, dec2, dec1, head) run K5
                   forward with K1 dx and K6 dW, the classifier K1/K6,
                   the stem pool K4, the loss K7. On by default, as
                   fused_eval, where the JAX package ships it off: that
                   package keeps its Pallas train zone off on the TPU
                   only for layout copies at the XLA/Pallas seams
                   (docs/roofline.md), which the card does not have, and
                   on the H100 the zone's step is the faster one at
                   batch 16 and 32 (the A/B matrix of
                   tools/profile_train.py, PERF.md). Both paths compute
                   the same function. Per b16 step at the flagship
                   width: K5 x16, K1 x18, K6 x17, K4 x1, K7 1 + 1.
    fused_train_deconv: the train-mode decoder upsamples (dec2, dec1)
                   at exact 2x run ops/deconv.py:deconv2x_ad — K3
                   forward, K10 input and weight gradient in one launch
                   (per step 2 each) — instead of F.conv_transpose2d under
                   autograd. Off by default, as in the JAX package;
                   independent of fused_train, as there.
    quant_eval:    int8 post-training quantization (ops/quant.py) of
                   the eval model's int8 zone — the JAX package's packed
                   zone: stem, enc1, dec2, dec1 and the head conv10.
                   Its convs multiply s8 x s8 into s32 and dequantize
                   into the BN fold; the model needs calibrated
                   activation scales (``calibrate``) before it runs.
    quant_percentile: calibration statistic — 0 records the abs-max of
                   each conv input, P > 0 the P-th percentile of its
                   nonzero |x| (ops/quant.py:calib_batch_range).
    quant_train:   int8 QAT (ops/quant.py:fake_quant_act and
                   fake_quant_weight, straight-through gradients,
                   dynamic per-batch activation scales) at the JAX
                   package's QAT points — the inputs and kernels of
                   the packed zone's convs (stem, enc1, dec2, dec1,
                   head; the classifier's kernel only) and the dec2 and
                   dec1 deconvs' input and kernel — in train AND eval
                   passes while set. The percentile of its activation
                   grid is ``quant_percentile``. The zone exists at
                   depth 5 for input widths that are a multiple of 16;
                   elsewhere the models raise.
    remat:         the train-mode model recomputes each encoder and
                   decoder stage in backward (torch.utils.checkpoint;
                   JAX's nn.remat per stage) instead of holding its
                   activations; only the stage boundaries (the skips)
                   stay. The parameters and the state_dict are the
                   same, so checkpoints interchange. With fused_train
                   each step launches K5 15 more times (enc1, dec2 and
                   dec1 recomputed; the stem and the head are in no
                   stage).
    """

    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32
    fused_eval: bool = True
    fused_train: bool = True
    fused_train_deconv: bool = False
    quant_eval: bool = False
    quant_percentile: float = 0.0
    quant_train: bool = False
    remat: bool = False

    @staticmethod
    def f32() -> "Policy":
        """Full float32, kernel zones off — numerical parity mode."""
        return Policy(compute_dtype=torch.float32, fused_eval=False,
                      fused_train=False)

    @staticmethod
    def int8() -> "Policy":
        """int8 PTQ deploy (the JAX package's ``Policy.tpu_int8()`` in
        its fused form): bf16 compute, the kernel zone on, the int8
        zone on the s8 kernels."""
        return Policy(fused_eval=True, quant_eval=True)
