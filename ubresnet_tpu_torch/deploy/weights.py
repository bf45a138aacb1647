"""Reference-format weights for the port (counterpart of
ubresnet_tpu/deploy/importers.py and exporters.py).

The port's models read the reference's state_dict key names directly,
so a reference ``.tar`` checkpoint ({iter, epoch, state_dict,
best_prec1, optimizer}) loads as it is; JAX-package variables cross
over through ``state_dict_from_jax``, and a calibrated int8 'quant'
collection through ``quant_scales_from_jax``.

Layouts: conv OIHW ↔ JAX HWIO (transpose 3, 2, 0, 1); deconv IOHW ↔
JAX (kh, kw, ci, co) (transpose 2, 3, 0, 1); BN weight/bias ↔
scale/bias, running_mean/var ↔ batch_stats mean/var.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from ubresnet_tpu_torch.models.registry import arch_of

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def state_dict_from_jax(variables: Dict) -> StateDict:
    """JAX-package UResNet or ASPPResNet variables ``{params,
    batch_stats}`` (nested dicts of arrays) → reference UResNet or
    ASPP_ResNet state_dict (mirrors ubresnet_tpu/deploy/exporters.py:
    export_uresnet_state_dict, and export_aspp_state_dict when the
    params hold ``aspp3``, as importers.py:160 tells them apart)."""
    p, s = variables["params"], variables["batch_stats"]
    out: StateDict = {}

    def conv(key, q, transpose=(3, 2, 0, 1)):
        out[f"{key}.weight"] = _t(np.asarray(q["kernel"]).transpose(*transpose))
        if "bias" in q:
            out[f"{key}.bias"] = _t(q["bias"])

    def bn(key, q, st):
        out[f"{key}.weight"] = _t(q["scale"])
        out[f"{key}.bias"] = _t(q["bias"])
        out[f"{key}.running_mean"] = _t(st["mean"])
        out[f"{key}.running_var"] = _t(st["var"])

    def convbn(ck, bk, q, st):
        conv(ck, q["conv"])
        bn(bk, q["bn"], st["bn"])

    def block(pref, q, st):
        convbn(f"{pref}.conv1", f"{pref}.bn1", q["cb1"], st["cb1"])
        convbn(f"{pref}.conv2", f"{pref}.bn2", q["cb2"], st["cb2"])
        if "bypass" in q:
            convbn(f"{pref}.bypass", f"{pref}.bnpass", q["bypass"],
                   st["bypass"])

    def double(pref, q, st):
        for r in ("res1", "res2"):
            block(f"{pref}.{r}", q[r], st[r])

    convbn("conv1", "bn1", p["stem"], s["stem"])
    i = 1
    while f"enc{i}" in p:
        double(f"enc_layer{i}", p[f"enc{i}"], s[f"enc{i}"])
        conv(f"dec_layer{i}.deconv", p[f"dec{i}"]["deconv"],
             transpose=(2, 3, 0, 1))
        double(f"dec_layer{i}.res", p[f"dec{i}"]["res"], s[f"dec{i}"]["res"])
        i += 1
    if "aspp3" in p:
        for i in (3, 4, 5):
            for b in (1, 2, 3, 4):
                convbn(f"ASPP_layer_enc{i}.B{b}_conv",
                       f"ASPP_layer_enc{i}.B{b}_bn",
                       p[f"aspp{i}"][f"b{b}"], s[f"aspp{i}"][f"b{b}"])
            convbn(f"ASPP_combine_enc{i}.ASPP_conv",
                   f"ASPP_combine_enc{i}.ASPP_bn",
                   p[f"aspp{i}_post"]["post"], s[f"aspp{i}_post"]["post"])
    convbn("conv10", "bn10", p["head"], s["head"])
    conv("conv11", p["classifier"])
    return out


def quant_scales_from_jax(quant: Dict) -> Dict[str, torch.Tensor]:
    """JAX-package calibrated 'quant' collection (nested dicts ending in
    ``act_scale`` scalars) → the port's scales, {JAX layer path joined
    by dots: float32 scalar}, e.g. ``enc1.res1.cb1`` — what
    ``ops.quant.calibrate`` returns and ``UResNet.set_quant_scales``
    takes."""
    out: Dict[str, torch.Tensor] = {}

    def walk(prefix, node):
        for k, v in node.items():
            if k == "act_scale":
                out[prefix] = torch.tensor(np.float32(np.asarray(v)))
            else:
                walk(f"{prefix}.{k}" if prefix else k, v)

    walk("", quant)
    return out


def strip_module_prefix(sd: Dict) -> Dict:
    """Remove DataParallel's ``module.`` key prefix when present."""
    if any(k.startswith("module.") for k in sd):
        return {k[len("module."):] if k.startswith("module.") else k: v
                for k, v in sd.items()}
    return sd


def load_reference_checkpoint(path: str) -> Tuple[StateDict, Dict]:
    """Read a reference ``.tar`` checkpoint → (state_dict of f32 CPU
    tensors without the ``module.`` prefix, info). ``info`` carries the
    geometry the importer infers (inplanes, input_channels,
    num_classes) and the architecture the keys hold (``arch``:
    models/registry.py:arch_of).
    The file is a pickle, as the reference writes it: load only
    checkpoints you trust."""
    payload = torch.load(path, map_location="cpu", weights_only=False)
    sd = payload.get("state_dict", payload) if isinstance(payload, dict) \
        else payload
    sd = strip_module_prefix({
        k: torch.as_tensor(v).detach().float() for k, v in sd.items()
        if not k.endswith("num_batches_tracked")
    })
    w = sd["conv1.weight"]
    info = {
        "inplanes": int(w.shape[0]),
        "input_channels": int(w.shape[1]),
        "num_classes": int(sd["conv11.weight"].shape[0]),
        "arch": arch_of(sd),
    }
    return sd, info


def save_reference_checkpoint(sd: StateDict, path: str) -> str:
    """Write ``sd`` in the reference's ``.tar`` envelope (iteration 0,
    empty optimizer state)."""
    torch.save({
        "iter": 0,
        "epoch": 0.0,
        "state_dict": {k: v.detach().cpu().float() for k, v in sd.items()},
        "best_prec1": 0.0,
        "optimizer": {},
    }, path)
    return path


def random_state_dict(seed: int = 0, *, inplanes: int = 16,
                      input_channels: int = 1, num_classes: int = 3,
                      depth: int = 5, arch: str = "uresnet",
                      aspp_branch_features: int = 16) -> StateDict:
    """Seeded random weights of a UResNet — by default the flagship
    (inplanes 16, 1 input channel, 3 classes, depth 5;
    final_conv_kernels 16) — or, with ``arch="aspp_resnet"``, of an
    ASPP_ResNet of depth 5 (ASPP_ResNet.py naming, the layout
    tests/test_aspp_importer.py builds: the widened dec5, dec4 and dec3
    and, at encoder stages 3-5, four ``aspp_branch_features``-wide
    branches and the recompression), under the reference key names:
    convs drawn as the reference initialises them (normal with std
    sqrt(2 / (k·k·out)), ub_uresnet.py:72-79), BN near identity with
    random running statistics, small conv biases."""
    if arch not in ("uresnet", "aspp_resnet"):
        raise ValueError(f"unknown arch {arch!r}")
    aspp = arch == "aspp_resnet"
    if aspp and depth != 5:
        raise ValueError(f"ASPP_ResNet has depth 5, not {depth}")
    fk = 16
    rng = np.random.RandomState(seed)
    sd: StateDict = {}

    def conv(key, cout, cin, k, bias=False):
        std = math.sqrt(2.0 / (k * k * cout))
        sd[f"{key}.weight"] = _t(rng.randn(cout, cin, k, k) * std)
        if bias:
            sd[f"{key}.bias"] = _t(rng.randn(cout) * 0.05)

    def bn(key, c):
        sd[f"{key}.weight"] = _t(1.0 + 0.1 * rng.randn(c))
        sd[f"{key}.bias"] = _t(0.05 * rng.randn(c))
        sd[f"{key}.running_mean"] = _t(0.05 * rng.randn(c))
        sd[f"{key}.running_var"] = _t(rng.rand(c) * 0.5 + 0.75)

    def block(pref, cin, cout, stride):
        conv(f"{pref}.conv1", cout, cin, 3)
        bn(f"{pref}.bn1", cout)
        conv(f"{pref}.conv2", cout, cout, 3)
        bn(f"{pref}.bn2", cout)
        if cin != cout or stride > 1:
            conv(f"{pref}.bypass", cout, cin, 1)
            bn(f"{pref}.bnpass", cout)

    chans = [inplanes * 2 ** i for i in range(depth + 1)]
    conv("conv1", inplanes, input_channels, 7, bias=True)
    bn("bn1", inplanes)
    for i in range(1, depth + 1):
        block(f"enc_layer{i}.res1", chans[i - 1], chans[i], 1 if i == 1 else 2)
        block(f"enc_layer{i}.res2", chans[i], chans[i], 1)
    # decoder stage i: deconv (ci → cu), then res over cu + skip → co
    plan = {i: (chans[i], chans[i - 1], 2 * chans[i - 1], chans[i - 1])
            for i in range(1, depth + 1)}
    if aspp:  # ASPP_ResNet.py:361-375
        p = inplanes
        plan.update({5: (64 * p, 16 * p, 48 * p, 32 * p),
                     4: (32 * p, 8 * p, 24 * p, 16 * p),
                     3: (16 * p, 4 * p, 8 * p, 4 * p)})
    for i in range(depth, 0, -1):
        cin, cu, cres, cout = plan[i]
        std = math.sqrt(2.0 / (16 * cu))
        sd[f"dec_layer{i}.deconv.weight"] = _t(rng.randn(cin, cu, 4, 4) * std)
        block(f"dec_layer{i}.res.res1", cres, cout, 1)
        block(f"dec_layer{i}.res.res2", cout, cout, 1)
    if aspp:
        bf = aspp_branch_features
        for i in (3, 4, 5):
            cin = chans[i]
            for b, k in ((1, 1), (2, 3), (3, 3), (4, 3)):
                conv(f"ASPP_layer_enc{i}.B{b}_conv", bf, cin, k, bias=True)
                bn(f"ASPP_layer_enc{i}.B{b}_bn", bf)
            conv(f"ASPP_combine_enc{i}.ASPP_conv", cin, 4 * bf + cin, 1,
                 bias=True)
            bn(f"ASPP_combine_enc{i}.ASPP_bn", cin)
    conv("conv10", fk, inplanes, 7, bias=True)
    bn("bn10", fk)
    conv("conv11", num_classes, fk, 7, bias=True)
    return sd
