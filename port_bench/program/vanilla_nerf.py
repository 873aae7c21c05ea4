"""The ``vanilla_nerf`` configuration built in the program: the port's
``VanillaNeRFRadianceField`` at the configuration's widths, holding the
weights the benchmark drew."""

from __future__ import annotations

import torch

from nerfacc_tpu_torch.models import VanillaNeRFRadianceField


def _program_name(leaf: str, n_trunk: int) -> str:
    prefix, k, kind = leaf.split(".")
    k = int(k)
    if prefix == "density":
        layer = (f"mlp.base.layers.{k}" if k < n_trunk
                 else "mlp.sigma_layer")
    else:
        layer = ("mlp.bottleneck_layer", "mlp.rgb_layer.layers.0",
                 "mlp.rgb_layer.layers.1")[k]
    return f"{layer}.{kind}"


def build(cfg: dict, weights: dict, device):
    """(field, leaves): the field with ``weights`` copied in, and its
    parameters in the order of ``weights``."""
    dens, color = cfg["linear_layers"]["density"], cfg["linear_layers"]["color"]
    field = VanillaNeRFRadianceField(
        net_depth=len(dens) - 1, net_width=dens[0][1],
        skip_layer=cfg["skip_after"], net_depth_condition=len(color) - 2,
        net_width_condition=color[1][1], device=device)
    params = dict(field.named_parameters())
    leaves = [params[_program_name(k, len(dens) - 1)] for k in weights]
    with torch.no_grad():
        for p, w in zip(leaves, weights.values()):
            if p.shape != w.shape:
                raise ValueError(f"the port's vanilla field has other "
                                 f"widths: {tuple(p.shape)} vs "
                                 f"{tuple(w.shape)}")
            p.copy_(w)
    return field, leaves
