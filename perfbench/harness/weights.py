"""Seeded weights, made on the card in a few large draws.

The configuration's ``weights.rules`` map each leaf of the detector's state
dict (first matching regular expression) to ``[pattern, dist, scale(,
factor)]``:

* ``normal`` with a number (the std) or ``he_fan_out`` (std sqrt(2 /
  fan_out), the ResNet's He init);
* ``uniform`` with ``xavier`` (bound sqrt(6 / (fan_in + fan_out))) or
  ``caffe2_xavier`` (bound sqrt(3 / fan_in));
* ``trunc_normal`` with ``lecun`` (flax's lecun_normal: std sqrt(1 /
  fan_in), truncated at two standard deviations, rescaled);
* ``const`` with its value;

and an optional factor (the box head's fc1 x 0.02 that tempers random
heads). All normal values come from one draw and all uniform values from
another, from a ``torch.Generator`` on the card, then are cut into leaves
and scaled. The leaves and their layer types come from the reference's
module tree, so the program's state is not read. ``calibrate_frozen_bn``
images then set every FrozenBN's mean and variance to those of its input,
layer after layer, in the reference's forward, as a pretrained trunk's
statistics keep its activations near unit scale. ``calibrate_prototypes``
then places PLN's prototypes and the known classifier on the embeddings of
ground-truth boxes, as training would, so that both branches of the
open-set cascade get detections: random prototypes lie far from every
embedding and would send every box to the unknown branch.
"""
from __future__ import annotations

import math
import re
from typing import Callable, Dict, List, Tuple

import torch
from torch import nn

TRUNC = 2.0  # lecun_normal truncates at two standard deviations
TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def _fans(module: nn.Module, w: torch.Tensor) -> Tuple[int, int]:
    if isinstance(module, nn.Linear):
        return w.shape[1], w.shape[0]
    if isinstance(module, nn.ConvTranspose2d):  # (I, O, kh, kw)
        k = w.shape[2] * w.shape[3]
        return w.shape[0] * k, w.shape[1] * k
    if w.dim() == 4:  # (O, I, kh, kw)
        k = w.shape[2] * w.shape[3]
        return w.shape[1] * k, w.shape[0] * k
    return w.shape[-1], w.shape[0]


def leaf_plan(model: nn.Module, rules: List[list]) -> List[Tuple[str, tuple, str, float, float]]:
    """(name, shape, dist, scale, factor) for every leaf of ``model``'s
    state dict, in its order."""
    owner = {}
    for mname, m in model.named_modules():
        for pname, _ in list(m.named_parameters(recurse=False)) + list(m.named_buffers(recurse=False)):
            owner[f"{mname}.{pname}" if mname else pname] = m
    compiled = [(re.compile(r[0]), r[1:]) for r in rules]
    plan = []
    for name, t in model.state_dict().items():
        for pattern, rule in compiled:
            if pattern.search(name):
                break
        else:
            raise ValueError(f"no weight rule matches {name!r}")
        dist, scale = rule[0], rule[1]
        factor = float(rule[2]) if len(rule) > 2 else 1.0
        if isinstance(scale, str):
            fan_in, fan_out = _fans(owner[name], t)
            scale = {"he_fan_out": math.sqrt(2.0 / fan_out), "xavier": math.sqrt(6.0 / (fan_in + fan_out)),
                     "caffe2_xavier": math.sqrt(3.0 / fan_in), "lecun": math.sqrt(1.0 / fan_in) / TRUNC_STD}[scale]
        plan.append((name, tuple(t.shape), dist, float(scale), factor))
    return plan


def make_weights(model: nn.Module, rules: List[list], seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """The seeded f32 state dict of ``model``'s layout on ``device``."""
    plan = leaf_plan(model, rules)
    size = {d: sum(math.prod(s) for _, s, dist, _, _ in plan if dist == d) for d in ("normal", "uniform")}
    size["uniform"] += sum(math.prod(s) for _, s, dist, _, _ in plan if dist == "trunc_normal")
    g = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(size["normal"], generator=g, device=device)
    uniform = torch.rand(size["uniform"], generator=g, device=device)
    at = {"normal": 0, "uniform": 0}
    lo, hi = 0.5 * (1 + math.erf(-TRUNC / math.sqrt(2))), 0.5 * (1 + math.erf(TRUNC / math.sqrt(2)))
    out = {}
    for name, shape, dist, scale, factor in plan:
        n = math.prod(shape)
        if dist == "const":
            out[name] = torch.full(shape, scale * factor, device=device)
            continue
        src = "normal" if dist == "normal" else "uniform"
        u = (normal if src == "normal" else uniform)[at[src]: at[src] + n].view(shape)
        at[src] += n
        if dist == "normal":
            v = u * scale
        elif dist == "uniform":
            v = (u * 2.0 - 1.0) * scale
        elif dist == "trunc_normal":  # inverse CDF of the truncated normal
            v = torch.erfinv((lo + u * (hi - lo)) * 2.0 - 1.0) * (math.sqrt(2.0) * scale)
        else:
            raise ValueError(f"unknown weight distribution {dist!r}")
        out[name] = v * factor if factor != 1.0 else v
    return out


def calibrate_frozen_bn(model: nn.Module, run: Callable[[], None], bn_type: type) -> int:
    """Run ``run()`` (a forward of ``model``) with every ``bn_type`` taking
    its input's per-channel mean and variance first; returns their count."""

    def hook(bn, args):
        x = args[0].float()
        bn.mean.copy_(x.mean(dim=(0, 2, 3)))
        bn.var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules() if isinstance(m, bn_type)]
    try:
        with torch.no_grad():
            run()
    finally:
        for h in handles:
            h.remove()
    return len(handles)


def calibrate_prototypes(model: nn.Module, h_props: torch.Tensor, h_src: torch.Tensor, near_share: float,
                         logit: float, unk_thr: float) -> Tuple[float, float]:
    """Place PLN's prototypes and the known classifier of ``model`` (the
    reference's detector, cosine distance) on box-head outputs: ``h_props``
    (N, fc) of the proposals of a few images, ``h_src`` (K * R, fc) of one
    source box for each prototype, in prototype order (class-major).

    The encoder's bias takes away ``alpha`` times the proposals' mean
    embedding (a negative ``alpha`` adds it, drawing the embeddings
    together), ``alpha`` the one on a grid of 201 in [-1, 1] that brings
    the share of proposals within ``unk_thr`` of a prototype nearest to
    ``near_share``, the smallest in magnitude among equals; each prototype is its source's embedding. Each known
    class's classifier row is the direction from the proposals' mean
    reconstruction to its first source's, scaled so that the source reads
    ``logit`` and the mean reads 0. Returns (alpha, the share reached)."""
    pln, cls = model.pln, model.classifier.cls_score
    enc_w, enc_b = pln.encoder.weight.detach().float(), pln.encoder.bias.detach().float()
    e_p = h_props.float() @ enc_w.T + enc_b
    e_s = h_src.float() @ enc_w.T + enc_b
    mu = e_p.mean(0)

    def unit(x):
        return x * torch.rsqrt(torch.sum(x * x, -1, keepdim=True) + 1e-12)

    def share(alpha):
        dist = 1.0 - unit(e_p - alpha * mu) @ unit(e_s - alpha * mu).T
        return float((dist.amin(1) <= unk_thr).float().mean())

    alphas = [i / 100 for i in range(-100, 101)]
    shares = [share(a) for a in alphas]
    best = min(range(len(alphas)), key=lambda i: (abs(shares[i] - near_share), abs(alphas[i]), alphas[i]))
    alpha = alphas[best]
    K = cls.weight.shape[0] - 1
    reps = e_s - alpha * mu
    dec_w, dec_b = pln.decoder.weight.detach().float(), pln.decoder.bias.detach().float()
    m = ((e_p - alpha * mu) @ dec_w.T + dec_b).mean(0)
    v = (reps @ dec_w.T + dec_b)[:: reps.shape[0] // K][:K] - m
    w = logit * v / torch.sum(v * v, -1, keepdim=True)
    with torch.no_grad():
        pln.encoder.bias.sub_((alpha * mu).to(pln.encoder.bias.dtype))
        pln.representatives.copy_(reps.to(pln.representatives.dtype))
        cls.weight[:K] = w.to(cls.weight.dtype)
        cls.bias[:K] = -(w @ m).to(cls.bias.dtype)
    return alpha, shares[best]
