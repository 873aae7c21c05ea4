"""The plain reference of the ``vanilla_nerf`` configuration: NeRF's MLP
(Mildenhall et al. 2020) as nerfacc's example configures it, in plain
PyTorch and f32, and the draw of its weights from a seed.

Positions are encoded as ``[x, sin(2^i x), sin(2^i x + pi / 2)]`` for i
below 10 (directions: below 4), grouped sin-block then cos-block, each
block frequency-major. The trunk is 8 relu layers of 256 with the encoded
position concatenated back after the fifth; the density is the relu of
one linear output of the trunk; the colour branch takes a 256-wide
bottleneck of the trunk and the encoded direction through one relu layer
of 128 and a sigmoid. Every layer has a bias.
"""

from __future__ import annotations

import math

import torch

from .common import linear


def layer_shapes(cfg: dict):
    d = cfg["linear_layers"]
    return d["density"], d["color"]


def leaf_names(cfg: dict):
    dens, color = layer_shapes(cfg)
    names = []
    for prefix, layers in (("density", dens), ("color", color)):
        for k in range(len(layers)):
            names += [f"{prefix}.{k}.weight", f"{prefix}.{k}.bias"]
    return names


def init_weights(cfg: dict, seed: int, device) -> dict:
    """The weights a seed gives, drawn on ``device`` in one call: every
    weight uniform in +-sqrt(6 / (in + out)) (xavier), from one draw of
    [-1, 1) scaled per layer; biases zero."""
    g = torch.Generator(device=device).manual_seed(seed)
    dens, color = layer_shapes(cfg)
    layers = [("density", k, s) for k, s in enumerate(dens)] + [
        ("color", k, s) for k, s in enumerate(color)]
    flat = torch.empty(sum(i * o for _, _, (i, o) in layers), device=device)
    flat.uniform_(-1.0, 1.0, generator=g)
    out, at = {}, 0
    for prefix, k, (i, o) in layers:
        bound = math.sqrt(6.0 / (i + o))
        out[f"{prefix}.{k}.weight"] = flat[at:at + i * o].reshape(o, i) * bound
        out[f"{prefix}.{k}.bias"] = torch.zeros(o, device=device)
        at += i * o
    return out


def encode(x: torch.Tensor, degrees: int) -> torch.Tensor:
    scales = torch.tensor([2.0 ** i for i in range(degrees)], dtype=x.dtype,
                          device=x.device)
    xb = (x[..., None, :] * scales[:, None]).reshape(
        x.shape[:-1] + (degrees * x.shape[-1],))
    return torch.cat([x, torch.sin(torch.cat([xb, xb + 0.5 * math.pi],
                                             dim=-1))], dim=-1)


class Field:
    """The field over the leaves ``params`` (a dict of tensors in
    :func:`leaf_names` order); ``tf32`` computes its matrix products in
    TF32 (the control)."""

    def __init__(self, cfg: dict, params: dict, tf32: bool = False):
        self.cfg, self.p, self.tf32 = cfg, params, tf32
        dens, color = layer_shapes(cfg)
        self.n_trunk = len(dens) - 1  # the last density layer is sigma
        self.skip = cfg["skip_after"]
        self.pos_deg, self.dir_deg = cfg["pos_degrees"], cfg["dir_degrees"]

    def leaves(self):
        return [self.p[k] for k in leaf_names(self.cfg)]

    def _lin(self, x, name):
        return linear(x, self.p[f"{name}.weight"], self.p[f"{name}.bias"],
                      tf32=self.tf32)

    def _trunk(self, x):
        inputs = encode(x, self.pos_deg)
        h = inputs
        for k in range(self.n_trunk):
            h = torch.relu(self._lin(h, f"density.{k}"))
            if k == self.skip:
                h = torch.cat([h, inputs], dim=-1)
        return h

    def density(self, x):
        return torch.relu(self._lin(self._trunk(x), f"density.{self.n_trunk}"))

    def __call__(self, x, d):
        h = self._trunk(x)
        sigma = torch.relu(self._lin(h, f"density.{self.n_trunk}"))
        h = torch.cat([self._lin(h, "color.0"), encode(d, self.dir_deg)],
                      dim=-1)
        h = torch.relu(self._lin(h, "color.1"))
        return torch.sigmoid(self._lin(h, "color.2")), sigma
