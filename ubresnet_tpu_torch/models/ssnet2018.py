"""Programmatic generator of the 2018-paper SSNet caffe graph (a copy
of ubresnet_tpu/models/ssnet2018.py: the same text for every width).

Emits prototxt text structurally identical to the reference's
models/dllee_ssnet2018.prototxt (conv0 stem, res1..res5 encoder with
branch1 projections, 5 grouped-bilinear deconv+concat stages, res6..
res9 decoder blocks, conv10/conv11+BN+ReLU head, softmax) from the
channel plan, so the framework carries the parity-target architecture
without shipping a copied model file. Feed the output to
parity/caffe.py:CaffeNet together with the official
.caffemodel weights (caffe/run_caffe_precropped.py:26-30) for the
golden-model oracle.

Verified structural details (against the reference file):
  * pool0 has no pad (caffe ceil-mode output 256 at 512 input)
  * concat order is (skip, deconv) — skip channels first
  * ReLUs are in-place, so skip tensors are post-activation
  * deconv4 concatenates with conv0 (full-resolution stem output)
  * decoder res stages exist only after deconv0..3; deconv4_concat
    feeds conv10 directly
  * conv11 is followed by BatchNorm+Scale+ReLU before the softmax
    (unlike the pytorch port, ub_uresnet.py:19-22)
"""
from __future__ import annotations

from typing import List, Tuple


def _conv(name, bottom, top, num_output, k, pad, stride=1, bias=False,
          group=1, filler="msra"):
    bias_line = "" if bias else "\n    bias_term: false"
    group_line = f"\n    group: {group}" if group > 1 else ""
    return f"""
layer {{
  name: "{name}"
  type: "Convolution"
  bottom: "{bottom}"
  top: "{top}"
  convolution_param {{
    num_output: {num_output}
    kernel_size: {k}
    pad: {pad}
    stride: {stride}{bias_line}{group_line}
    weight_filler {{ type: "{filler}" }}
  }}
}}"""


def _bn_scale(base, blob):
    return f"""
layer {{
  name: "bn{base}"
  type: "BatchNorm"
  bottom: "{blob}"
  top: "{blob}"
}}
layer {{
  name: "scale{base}"
  type: "Scale"
  bottom: "{blob}"
  top: "{blob}"
  scale_param {{ bias_term: true }}
}}"""


def _relu(name, blob):
    return f"""
layer {{
  name: "{name}"
  type: "ReLU"
  bottom: "{blob}"
  top: "{blob}"
}}"""


def _res_block(idx: str, bottom: str, cout: int, stride: int, project: bool,
               k: int = 3):
    """One caffe BasicBlock: branch2a/2b (+branch1 projection), Eltwise,
    ReLU — with the pre-add ReLU on branch2b. The reference's res9
    stage uses 5x5 branch convs (dllee_ssnet2018.prototxt:2335-2338);
    pass k=5 there."""
    parts = []
    if project:
        parts.append(
            _conv(f"res{idx}_branch1", bottom, f"res{idx}_branch1", cout, 1, 0,
                  stride)
        )
        parts.append(_bn_scale(f"{idx}_branch1", f"res{idx}_branch1"))
        bypass = f"res{idx}_branch1"
    else:
        bypass = bottom
    parts.append(
        _conv(f"res{idx}_branch2a", bottom, f"res{idx}_branch2a", cout, k,
              k // 2, stride)
    )
    parts.append(_bn_scale(f"{idx}_branch2a", f"res{idx}_branch2a"))
    parts.append(_relu(f"res{idx}_branch2a_relu", f"res{idx}_branch2a"))
    parts.append(
        _conv(f"res{idx}_branch2b", f"res{idx}_branch2a", f"res{idx}_branch2b",
              cout, k, k // 2, 1)
    )
    parts.append(_bn_scale(f"{idx}_branch2b", f"res{idx}_branch2b"))
    parts.append(_relu(f"res{idx}_branch2b_relu", f"res{idx}_branch2b"))
    parts.append(f"""
layer {{
  name: "res{idx}"
  type: "Eltwise"
  bottom: "{bypass}"
  bottom: "res{idx}_branch2b"
  top: "res{idx}"
}}""")
    parts.append(_relu(f"res{idx}_relu", f"res{idx}"))
    return "".join(parts)


def _deconv(i: int, bottom: str, skip: str, num_output: int):
    return f"""
layer {{
  name: "deconv{i}_deconv"
  type: "Deconvolution"
  bottom: "{bottom}"
  top: "deconv{i}_deconv"
  param {{ name: "par_deconv{i}_deconv_w" lr_mult: 1.0 }}
  param {{ name: "par_deconv{i}_deconv_b" lr_mult: 0.0 }}
  convolution_param {{
    num_output: {num_output}
    pad: 1
    kernel_size: 4
    group: {num_output}
    stride: 2
    weight_filler {{ type: "bilinear" }}
    bias_filler {{ type: "constant" value: 0.0 }}
  }}
}}
layer {{
  name: "deconv{i}_concat"
  type: "Concat"
  bottom: "{skip}"
  bottom: "deconv{i}_deconv"
  top: "deconv{i}_concat"
}}"""


def ssnet2018_prototxt(
    num_classes: int = 3,
    inplanes: int = 16,
    input_dim: Tuple[int, int, int, int] = (1, 1, 512, 512),
) -> str:
    p = inplanes
    out: List[str] = [
        f'name: "UResNet"\ninput: "data"'
        + "".join(f"\ninput_dim: {d}" for d in input_dim)
    ]
    # stem
    out.append(_conv("conv0", "data", "conv0", p, 7, 3, 1, bias=True))
    out.append(_bn_scale("_conv0", "conv0"))
    out.append(_relu("conv0_relu", "conv0"))
    out.append("""
layer {
  name: "pool0"
  type: "Pooling"
  bottom: "conv0"
  top: "pool0"
  pooling_param { kernel_size: 3 stride: 2 pool: MAX }
}""")
    # encoder res1..res5
    chans = [p * 2 ** i for i in range(1, 6)]  # 32..512 for p=16
    bottom = "pool0"
    for s, cout in enumerate(chans, start=1):
        stride = 1 if s == 1 else 2
        out.append(_res_block(f"{s}a", bottom, cout, stride, project=True))
        out.append(_res_block(f"{s}b", f"res{s}a", cout, 1, project=False))
        bottom = f"res{s}b"
    # decoder: 5 deconv+concat, res6..res9 after the first four
    skips = [f"res{s}b" for s in range(4, 0, -1)] + ["conv0"]
    dec_chans = chans[-2::-1] + [p]  # 256,128,64,32,16 for p=16
    for i, (skip, cout) in enumerate(zip(skips, dec_chans)):
        out.append(_deconv(i, bottom, skip, cout))
        bottom = f"deconv{i}_concat"
        if i < 4:
            idx = 6 + i
            k = 5 if idx == 9 else 3  # res9 uses 5x5 branch convs
            out.append(_res_block(f"{idx}a", bottom, cout, 1, project=True,
                                  k=k))
            out.append(_res_block(f"{idx}b", f"res{idx}a", cout, 1,
                                  project=False, k=k))
            bottom = f"res{idx}b"
    # head: conv10 + BN + ReLU, conv11 + BN + ReLU, softmax
    out.append(_conv("conv10", bottom, "conv10", p, 7, 3, 1, bias=True))
    out.append(_bn_scale("_conv10", "conv10"))
    out.append(_relu("conv10_relu", "conv10"))
    out.append(_conv("conv11", "conv10", "conv11", num_classes, 7, 3, 1,
                     bias=True))
    out.append(_bn_scale("_conv11", "conv11"))
    out.append(_relu("conv11_relu", "conv11"))
    out.append("""
layer {
  name: "softmax"
  type: "Softmax"
  bottom: "conv11"
  top: "softmax"
}""")
    return "".join(out) + "\n"
