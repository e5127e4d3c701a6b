"""ResNet (18-ish, configurable widths): the port of
easydist_tpu/models/resnet.py, in torch's layout (activations NCHW,
kernels OIHW; the JAX model is NHWC with HWIO kernels, and
`resnet_params_from_numpy` transposes).

GroupNorm instead of BatchNorm, as the JAX model: batch statistics would
tie the shards of a data-parallel step together.  Convolutions pad as
XLA's "SAME" pads (the odd pixel of a stride-2 window goes at the end),
so the port's outputs equal the JAX model's.  The architecture (strides,
shortcut flags) is a separate `arch` list, not part of the params, so the
gradients and the optimizer see float leaves only."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from easydist_tpu_torch import resolve_device

from .gpt import params_from_numpy
from .optim import sgd_update, value_and_grad


def _conv_init(generator, kh, kw, c_in, c_out, device):
    fan_in = kh * kw * c_in
    return (torch.randn((c_out, c_in, kh, kw), generator=generator,
                        device=generator.device)
            * math.sqrt(2.0 / fan_in)).to(device)


def _same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride=1):
    kh, kw = w.shape[2:]
    top, bottom = _same_pad(x.shape[2], kh, stride)
    left, right = _same_pad(x.shape[3], kw, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w, stride=stride)


def _groupnorm(x, g, b, groups=8, eps=1e-5):
    n, c, h, w = x.shape
    xg = x.reshape(n, groups, c // groups, h, w)
    mu = xg.mean(dim=(2, 3, 4), keepdim=True)
    var = xg.var(dim=(2, 3, 4), keepdim=True, unbiased=False)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return xg.reshape(n, c, h, w) * g[:, None, None] + b[:, None, None]


def resnet_init(generator: torch.Generator, widths=(16, 32, 64),
                blocks_per_stage=2, classes=10, in_channels=3,
                device=None) -> Tuple[Dict, List]:
    """(params, arch): params an all-float tree drawn from `generator`
    (on its own device) and placed on `device` (default: the card), arch
    the static strides and shortcut flags.  The numbers differ from the
    JAX package's for any seed; carry JAX weights across with
    `resnet_params_from_numpy`."""
    device = resolve_device(device)
    params: Dict = {"stem": _conv_init(generator, 3, 3, in_channels,
                                       widths[0], device),
                    "stages": [], "head": {}}
    arch: List[List[Dict]] = []
    c_in = widths[0]
    for c_out in widths:
        stage: List[Dict] = []
        stage_arch: List[Dict] = []
        for b in range(blocks_per_stage):
            stride = 2 if (b == 0 and c_out != widths[0]) else 1
            blk = {
                "conv1": _conv_init(generator, 3, 3, c_in, c_out, device),
                "gn1": {"g": torch.ones(c_out, device=device),
                        "b": torch.zeros(c_out, device=device)},
                "conv2": _conv_init(generator, 3, 3, c_out, c_out, device),
                "gn2": {"g": torch.ones(c_out, device=device),
                        "b": torch.zeros(c_out, device=device)},
            }
            has_short = stride != 1 or c_in != c_out
            if has_short:
                blk["short"] = _conv_init(generator, 1, 1, c_in, c_out,
                                          device)
            stage.append(blk)
            stage_arch.append({"stride": stride, "has_short": has_short})
            c_in = c_out
        params["stages"].append(stage)
        arch.append(stage_arch)
    params["head"] = {
        "w": (torch.randn((c_in, classes), generator=generator,
                          device=generator.device)
              / math.sqrt(c_in)).to(device),
        "b": torch.zeros(classes, device=device)}
    return params, arch


def resnet_params_from_numpy(tree, device=None) -> Dict:
    """The JAX package's ResNet parameters (numpy leaves) in the port's
    layout: every HWIO conv kernel [kh, kw, c_in, c_out] becomes OIHW
    [c_out, c_in, kh, kw]; norms and the head keep theirs."""
    params = params_from_numpy(tree, device=device)

    def oihw(w):
        return w.permute(3, 2, 0, 1).contiguous()

    params["stem"] = oihw(params["stem"])
    for stage in params["stages"]:
        for blk in stage:
            for k in ("conv1", "conv2", "short"):
                if k in blk:
                    blk[k] = oihw(blk[k])
    return params


def resnet_apply(params, arch, x):
    """x: [batch, C, H, W] -> logits [batch, classes]."""
    x = _conv(x, params["stem"])
    for stage, stage_arch in zip(params["stages"], arch):
        for blk, meta in zip(stage, stage_arch):
            h = _conv(x, blk["conv1"], stride=meta["stride"])
            h = torch.relu(_groupnorm(h, blk["gn1"]["g"], blk["gn1"]["b"]))
            h = _conv(h, blk["conv2"])
            h = _groupnorm(h, blk["gn2"]["g"], blk["gn2"]["b"])
            sc = x if not meta["has_short"] else _conv(x, blk["short"],
                                                      stride=meta["stride"])
            x = torch.relu(h + sc)
    x = x.mean(dim=(2, 3))
    return x @ params["head"]["w"] + params["head"]["b"]


def make_resnet_train_step(arch, lr=1e-2):
    """train_step(params, x, labels) -> (new params, loss): softmax
    cross-entropy, SGD."""

    def train_step(params, x, labels):
        def loss_fn(p):
            logp = torch.log_softmax(resnet_apply(p, arch, x), dim=-1)
            return -logp.gather(-1, labels.long()[:, None]).mean()

        loss, grads = value_and_grad(loss_fn, params)
        return sgd_update(params, grads, lr=lr), loss

    return train_step
