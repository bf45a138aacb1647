"""Caffe graph executor, the 2018-paper baseline engine, on the card
(counterpart of ubresnet_tpu/parity/caffe.py).

Re-provides the reference's Caffe1 parity rig
(caffe/run_caffe_precropped.py: prototxt + per-plane .caffemodel →
per-pixel softmax scores): the prototxt (protobuf text format) parses
into a layer DAG, the .caffemodel (protobuf binary) parses via the
wire-format walker, and the graph runs as torch ops (cuDNN on the card)
in float32 with TF32 off: it is the oracle that "all development will
be benchmarked against" (caffe/README.md:9-13).

Supported ops (the full dllee_ssnet2018.prototxt vocabulary):
Input, Convolution (groups/dilation), Deconvolution (grouped bilinear
expanded dense), BatchNorm (+ a Scale on the same blob, folded into one
affine, TEST mode), ReLU, Pooling (MAX, caffe ceil semantics), Concat,
Eltwise (SUM/PROD/MAX), Softmax, Dropout (TEST no-op), Crop.

Caffe semantics preserved exactly:
  * pooling output size uses ceil + the boundary clip rule, the
    high side padded with -inf
  * deconv out = s(in-1)+k-2p: F.conv_transpose2d with the caffe blob
    as it stands ((cin, cout, k, k) is torch's transpose layout)
  * BatchNorm blobs are (mean, var, scale_factor); TEST-mode stats

Weights are drawn as the JAX package draws them (the same RandomState
draws in the same layer order), so ``CaffeNet(prototxt, seed=s).params``
equals the JAX net's array for array.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ubresnet_tpu_torch.parity import protobuf_lite as pb
from ubresnet_tpu_torch.utils.platform import resolve_device, strict_f32_scope

# ------------------------------------------------------- prototxt text


def parse_prototxt(text: str) -> Dict[str, Any]:
    """Protobuf text format → dict (repeated keys become lists)."""
    tokens = _tokenize(text)
    pos = 0
    out: Dict[str, Any] = {}
    while pos < len(tokens):
        pos = _parse_entry(tokens, pos, out)
    return out


def _tokenize(text: str) -> List[str]:
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "#":
            while i < n and text[i] != "\n":
                i += 1
        elif c in " \t\r\n,":
            i += 1
        elif c in "{}:":
            out.append(c)
            i += 1
        elif c == '"':
            j = text.index('"', i + 1)
            out.append(text[i : j + 1])
            i = j + 1
        else:
            j = i
            while j < n and text[j] not in ' \t\r\n,{}:#"':
                j += 1
            out.append(text[i:j])
            i = j
    return out


def _parse_entry(tokens, pos, out) -> int:
    key = tokens[pos]
    pos += 1
    if pos < len(tokens) and tokens[pos] == ":":
        pos += 1
    if pos < len(tokens) and tokens[pos] == "{":
        val: Dict[str, Any] = {}
        pos += 1
        while tokens[pos] != "}":
            pos = _parse_entry(tokens, pos, val)
        pos += 1
    else:
        val = _scalar(tokens[pos])
        pos += 1
    if key in out:
        if not isinstance(out[key], list):
            out[key] = [out[key]]
        out[key].append(val)
    else:
        out[key] = val
    return pos


def _scalar(t):
    if t.startswith('"'):
        return t[1:-1]
    low = t.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(t)
    except ValueError:
        pass
    try:
        return float(t)
    except ValueError:
        pass
    return t  # enum like MAX / SUM


def _as_list(v) -> list:
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


# --------------------------------------------------------- caffemodel


# caffe.proto field numbers
_NET_LAYER = 100  # NetParameter.layer (LayerParameter)
_NET_LAYERS_V1 = 2  # NetParameter.layers (V1LayerParameter)
_LAYER_NAME, _LAYER_BLOBS = 1, 7
_V1_NAME, _V1_BLOBS = 4, 6
_BLOB_DATA, _BLOB_SHAPE = 5, 7
_BLOB_NUM, _BLOB_CH, _BLOB_H, _BLOB_W = 1, 2, 3, 4
_SHAPE_DIM = 1


def _parse_blob(buf: memoryview) -> np.ndarray:
    data: List[np.ndarray] = []
    shape: List[int] = []
    legacy = {}
    for field, wire, val in pb.iter_fields(buf):
        if field == _BLOB_DATA:
            data.append(pb.parse_packed_floats(val, wire))
        elif field == _BLOB_SHAPE:
            for f2, w2, v2 in pb.iter_fields(val):
                if f2 == _SHAPE_DIM:
                    if w2 == pb.WIRE_VARINT:
                        shape.append(v2)
                    else:  # packed varints
                        p = 0
                        while p < len(v2):
                            d, p = pb.read_varint(v2, p)
                            shape.append(d)
        elif field in (_BLOB_NUM, _BLOB_CH, _BLOB_H, _BLOB_W):
            legacy[field] = val
    # a fresh, writable float32 array (the chunks view the file's bytes)
    arr = np.concatenate(data or [np.zeros(0, "<f4")]).astype(np.float32,
                                                               copy=False)
    if shape:
        arr = arr.reshape(shape)
    elif legacy:
        dims = [legacy.get(k, 1) for k in (_BLOB_NUM, _BLOB_CH, _BLOB_H, _BLOB_W)]
        arr = arr.reshape(dims)
    return arr


def parse_caffemodel(path: str) -> Dict[str, List[np.ndarray]]:
    """.caffemodel → {layer_name: [blob arrays]} (new + V1 layers)."""
    with open(path, "rb") as f:
        buf = memoryview(f.read())
    out: Dict[str, List[np.ndarray]] = {}
    for field, wire, val in pb.iter_fields(buf):
        if field not in (_NET_LAYER, _NET_LAYERS_V1):
            continue
        name = None
        blobs: List[np.ndarray] = []
        name_field = _LAYER_NAME if field == _NET_LAYER else _V1_NAME
        blob_field = _LAYER_BLOBS if field == _NET_LAYER else _V1_BLOBS
        for f2, w2, v2 in pb.iter_fields(val):
            if f2 == name_field and w2 == pb.WIRE_BYTES:
                name = bytes(v2).decode()
            elif f2 == blob_field:
                blobs.append(_parse_blob(v2))
        if name and blobs:
            out[name] = blobs
    return out


def write_caffemodel(path: str, layers: Dict[str, List[np.ndarray]]):
    """Serialize {name: blobs} as a NetParameter binary (test fixtures,
    golden_parity's surrogate weights)."""
    body = []
    for name, blobs in layers.items():
        layer = [pb.field_string(_LAYER_NAME, name)]
        for b in blobs:
            shape = b"".join(pb.field_varint(_SHAPE_DIM, d) for d in b.shape)
            blob = (pb.field_bytes(_BLOB_SHAPE, shape)
                    + pb.field_packed_floats(_BLOB_DATA, b.ravel()))
            layer.append(pb.field_bytes(_LAYER_BLOBS, blob))
        body.append(pb.field_bytes(_NET_LAYER, b"".join(layer)))
    with open(path, "wb") as f:
        f.write(b"".join(body))


# ------------------------------------------------------------ fillers


def _expand_grouped_deconv(w: np.ndarray, cin: int, cout: int, group: int,
                           k: int) -> np.ndarray:
    """(cin, cout/group, k, k) grouped deconv weight → dense
    (cin, cout, k, k) with zeros off the group diagonal."""
    if group <= 1 or w.shape[1] == cout:  # already dense
        return w
    dense = np.zeros((cin, cout, k, k), np.float32)
    in_per, out_per = cin // group, cout // group
    for g in range(group):
        dense[g * in_per : (g + 1) * in_per,
              g * out_per : (g + 1) * out_per] = w[g * in_per : (g + 1) * in_per]
    return dense


def bilinear_kernel(k: int) -> np.ndarray:
    """Caffe's 'bilinear' weight filler (k, k)."""
    f = math.ceil(k / 2)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    og = np.ogrid[:k, :k]
    return ((1 - abs(og[0] / f - c)) * (1 - abs(og[1] / f - c))).astype(np.float32)


# ------------------------------------------------------------ executor


class CaffeNet(nn.Module):
    """Executable caffe graph on ``device`` (the card unless
    ``device="cpu"``). ``params`` holds the numpy weights as the JAX
    package's CaffeNet does (the grouped deconvs expanded dense);
    the module's buffers hold what the forward runs: the conv and deconv
    blobs, and each BatchNorm (with the Scale that follows it on the
    same blob) as one per-channel affine. ``net.double()`` runs the
    same graph in float64. The forward runs with TF32 off
    (utils/platform.py:strict_f32_scope): the net is the float32
    oracle."""

    POOL_MAX = {0, "MAX"}

    def __init__(
        self,
        prototxt: str,
        weights: Optional[Dict[str, List[np.ndarray]]] = None,
        seed: int = 0,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        if "\n" not in prototxt and prototxt.endswith((".prototxt", ".txt")):
            with open(prototxt) as f:
                prototxt = f.read()
        self.net = parse_prototxt(prototxt)
        self.name = self.net.get("name", "net")
        self.layers = [l for l in _as_list(self.net.get("layer"))]
        if not self.layers:
            raise ValueError("no 'layer' entries in prototxt")
        self.input_name = self.net.get("input", "data")
        dims = _as_list(self.net.get("input_dim")) or [1, 1, 512, 512]
        self.input_dim = tuple(int(d) for d in dims)  # NCHW in prototxt
        rng = np.random.RandomState(seed)
        self.params: Dict[str, List[np.ndarray]] = {}
        self._plan: List[Tuple[str, Any]] = []
        blob_channels = {self.input_name: self.input_dim[1]}
        for layer in self.layers:
            self._register(layer, weights or {}, rng, blob_channels)
        self._device = device
        self._ops = self._compile(device)

    # -- weight materialization (the JAX package's, draw for draw) ------
    def _register(self, layer, weights, rng, chans):
        lt = layer["type"]
        name = layer["name"]
        bottoms = _as_list(layer.get("bottom"))
        cin = chans.get(bottoms[0]) if bottoms else None

        def filler(shape, spec):
            ftype = (spec or {}).get("type", "constant")
            if ftype == "msra":
                # caffe MSRA default: fan_in = C_in*k*k
                fan_in = int(np.prod(shape[1:]))
                return rng.randn(*shape).astype(np.float32) * math.sqrt(2.0 / fan_in)
            if ftype == "bilinear":
                w = np.zeros(shape, np.float32)
                w[...] = bilinear_kernel(shape[-1])
                return w
            val = float((spec or {}).get("value", 0.0))
            return np.full(shape, val, np.float32)

        if lt == "Convolution":
            cp = layer["convolution_param"]
            cout = int(cp["num_output"])
            k = int(cp.get("kernel_size", 3))
            group = int(cp.get("group", 1))
            bias = bool(cp.get("bias_term", True))
            if name in weights:
                self.params[name] = [np.asarray(b, np.float32) for b in weights[name]]
            else:
                blobs = [filler((cout, cin // group, k, k), cp.get("weight_filler"))]
                if bias:
                    blobs.append(filler((cout,), cp.get("bias_filler")))
                self.params[name] = blobs
            chans[layer["top"]] = cout
        elif lt == "Deconvolution":
            cp = layer["convolution_param"]
            cout = int(cp["num_output"])
            k = int(cp.get("kernel_size", 4))
            group = int(cp.get("group", 1))
            bias = bool(cp.get("bias_term", True))
            if name in weights:
                blobs = [np.asarray(b, np.float32) for b in weights[name]]
            else:
                blobs = [filler((cin, cout // group, k, k), cp.get("weight_filler"))]
                if bias:
                    blobs.append(filler((cout,), cp.get("bias_filler")))
            # dense at load, as the JAX package keeps it
            blobs[0] = _expand_grouped_deconv(blobs[0], cin, cout, group, k)
            self.params[name] = blobs
            chans[layer["top"]] = cout
        elif lt == "BatchNorm":
            c = cin
            if name in weights:
                self.params[name] = [np.asarray(b, np.float32) for b in weights[name]]
            else:
                self.params[name] = [
                    np.zeros(c, np.float32),
                    np.ones(c, np.float32),
                    np.ones(1, np.float32),
                ]
            chans[layer["top"]] = c
        elif lt == "Scale":
            c = cin
            bias = bool(layer.get("scale_param", {}).get("bias_term", True))
            if name in weights:
                self.params[name] = [np.asarray(b, np.float32) for b in weights[name]]
            else:
                self.params[name] = [np.ones(c, np.float32)] + (
                    [np.zeros(c, np.float32)] if bias else []
                )
            chans[layer["top"]] = c
        elif lt == "Concat":
            chans[layer["top"]] = sum(chans[b] for b in bottoms)
        elif lt in ("ReLU", "Eltwise", "Pooling", "Softmax", "Dropout", "Crop"):
            chans[layer["top"]] = cin
        elif lt == "Input":
            shape = layer.get("input_param", {}).get("shape", {})
            dims = [int(d) for d in _as_list(shape.get("dim"))]
            if dims:
                self.input_dim = tuple(dims)
            self.input_name = layer["top"]
            chans[layer["top"]] = self.input_dim[1]
            return
        else:
            raise NotImplementedError(f"caffe layer type {lt}")
        self._plan.append((name, layer))

    # -- what the forward runs -----------------------------------------
    def _buffers_of(self, name: str, arrays, device) -> List[str]:
        """Register ``arrays`` as float32 buffers of layer ``name``;
        returns their attribute names."""
        base = "w_" + re.sub(r"\W", "_", name)
        keys = []
        for j, a in enumerate(arrays):
            key = f"{base}_{j}"
            if hasattr(self, key):
                raise ValueError(f"layer names collide on buffer {key}")
            self.register_buffer(key, torch.as_tensor(
                np.ascontiguousarray(a, np.float32)).to(device))
            keys.append(key)
        return keys

    def _compile(self, device) -> List[Tuple[str, str, List[str], str, Any]]:
        """The plan as (kind, top, bottoms, layer name, arg) steps, each
        layer's tensors registered as buffers; a Scale in place on a
        BatchNorm's top right after it joins the BatchNorm's affine."""
        ops = []
        plan = self._plan
        i = 0
        while i < len(plan):
            name, layer = plan[i]
            lt = layer["type"]
            bots = _as_list(layer.get("bottom"))
            top = layer["top"]
            p = self.params.get(name)
            if lt == "Convolution":
                cp = layer["convolution_param"]
                arg = dict(stride=int(cp.get("stride", 1)),
                           padding=int(cp.get("pad", 0)),
                           dilation=int(cp.get("dilation", 1)),
                           groups=int(cp.get("group", 1)))
                ops.append(("conv", top, bots,
                            self._buffers_of(name, p, device), arg))
            elif lt == "Deconvolution":
                cp = layer["convolution_param"]
                arg = dict(stride=int(cp.get("stride", 2)),
                           padding=int(cp.get("pad", 1)))
                ops.append(("deconv", top, bots,
                            self._buffers_of(name, p, device), arg))
            elif lt in ("BatchNorm", "Scale"):
                gain, shift = np.ones(1), np.zeros(1)
                if lt == "BatchNorm":
                    mean, var, sf = p[0], p[1], p[2]
                    s = np.float32(1.0 / sf[0] if sf[0] != 0 else 1.0)
                    gain = 1.0 / np.sqrt((var * s + np.float32(1e-5))
                                         .astype(np.float64))
                    shift = -(mean * s).astype(np.float64) * gain
                    nxt = plan[i + 1] if i + 1 < len(plan) else None
                    if (nxt is not None and nxt[1]["type"] == "Scale"
                            and _as_list(nxt[1].get("bottom")) == [top]
                            and nxt[1]["top"] == top):
                        i += 1
                        name, p = nxt[0], self.params[nxt[0]]
                        lt = "Scale"
                if lt == "Scale":
                    g = p[0].astype(np.float64)
                    gain, shift = gain * g, shift * g
                    if len(p) > 1:
                        shift = shift + p[1]
                ops.append(("affine", top, bots,
                            self._buffers_of(name, (gain, shift), device),
                            None))
            elif lt == "Pooling":
                pp = layer.get("pooling_param", {})
                if pp.get("pool", "MAX") not in self.POOL_MAX:
                    raise NotImplementedError("only MAX pooling")
                arg = dict(kernel_size=int(pp.get("kernel_size", 3)),
                           stride=int(pp.get("stride", 2)),
                           padding=int(pp.get("pad", 0)))
                ops.append(("pool", top, bots, [], arg))
            elif lt == "Eltwise":
                op = layer.get("eltwise_param", {}).get("operation", "SUM")
                ops.append(("eltwise", top, bots, [], op))
            else:  # ReLU, Concat, Softmax, Dropout, Crop
                ops.append((lt.lower(), top, bots, [], None))
            i += 1
        return ops

    # -- execution ------------------------------------------------------
    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: (b, h, w, c) NHWC → dict of all top blobs (incl. softmax),
        NHWC. Runs in the buffers' dtype (float32 unless ``.double()``),
        channels-last inside. No op writes in place: an in-place caffe
        layer rebinds its top, as the JAX package does."""
        with strict_f32_scope():
            return self._run(x)

    def _run(self, x):
        w0 = next(self.buffers(), None)
        x = x.to(device=self._device if w0 is None else w0.device,
                 dtype=torch.float32 if w0 is None else w0.dtype)
        x = x.permute(0, 3, 1, 2)
        blobs: Dict[str, torch.Tensor] = {
            self.input_name: x.contiguous(memory_format=torch.channels_last)}
        for kind, top, bots, keys, arg in self._ops:
            t = [getattr(self, k) for k in keys]
            xin = blobs[bots[0]] if bots else None
            if kind == "conv":
                y = F.conv2d(xin, t[0], t[1] if len(t) > 1 else None, **arg)
            elif kind == "deconv":
                y = F.conv_transpose2d(xin, t[0], t[1] if len(t) > 1 else None,
                                       **arg)
            elif kind == "affine":
                y = torch.addcmul(t[1].view(1, -1, 1, 1), xin,
                                  t[0].view(1, -1, 1, 1))
            elif kind == "relu":
                y = F.relu(xin)
            elif kind == "pool":
                y = _caffe_max_pool(xin, **arg)
            elif kind == "eltwise":
                y = blobs[bots[0]]
                for b in bots[1:]:
                    if arg == "PROD":
                        y = y * blobs[b]
                    elif arg == "MAX":
                        y = torch.maximum(y, blobs[b])
                    else:
                        y = y + blobs[b]
            elif kind == "concat":
                y = torch.cat([blobs[b] for b in bots], dim=1)
            elif kind == "softmax":
                y = F.softmax(xin, dim=1)
            elif kind == "dropout":
                y = xin  # TEST phase
            else:  # crop, at offset 0
                ref = blobs[bots[1]]
                y = xin[:, :, : ref.shape[2], : ref.shape[3]]
            blobs[top] = y
        return {k: v.permute(0, 2, 3, 1) for k, v in blobs.items()}


def _caffe_max_pool(x, kernel_size, stride, padding):
    """Caffe's MAX pooling: output ceil((d + 2p - k)/s) + 1, less one
    where the last window would start in the padding (the clip rule);
    the input is padded with -inf, p low and as much high as the last
    window needs."""
    h, w = x.shape[2], x.shape[3]
    pads = []
    for d in (w, h):  # F.pad's order: last dim first
        o = math.ceil((d + 2 * padding - kernel_size) / stride) + 1
        if padding and (o - 1) * stride >= d + padding:
            o -= 1
        pads += [padding, max((o - 1) * stride + kernel_size - d - padding, 0)]
    return F.max_pool2d(F.pad(x, pads, value=-math.inf), kernel_size, stride)
