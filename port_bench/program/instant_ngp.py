"""The ``instant_ngp`` configuration built in the program: the port's
``NGPRadianceField`` at the configuration's widths, holding the weights
the benchmark drew."""

from __future__ import annotations

import torch

from nerfacc_tpu_torch.models import NGPRadianceField

# the program's parameter of each reference leaf
LEAVES = {
    "table": "encoder.table",
    "density.0": "mlp_base.layers.0.weight",
    "density.1": "mlp_base.layers.1.weight",
    "color.0": "mlp_head.layers.0.weight",
    "color.1": "mlp_head.layers.1.weight",
    "color.2": "mlp_head.layers.2.weight",
}


def build(cfg: dict, weights: dict, device):
    """(field, leaves): the field with ``weights`` copied in, and its
    parameters in the order of ``weights``."""
    field = NGPRadianceField(
        aabb=cfg["aabb"], geo_feat_dim=cfg["geo_feat_dim"],
        n_levels=cfg["levels"], n_features=cfg["features"],
        log2_hashmap_size=cfg["log2_table"],
        pallas_grad=cfg["program"]["pallas_grad"], device=device)
    if int(field.encoder._res[0]) != cfg["base_resolution"]:
        raise ValueError("the port's hash encoder has another base "
                         "resolution")
    params = dict(field.named_parameters())
    leaves = [params[LEAVES[k]] for k in weights]
    with torch.no_grad():
        for p, w in zip(leaves, weights.values()):
            if p.shape != w.shape:
                raise ValueError(f"the port's NGP field has other widths: "
                                 f"{tuple(p.shape)} vs {tuple(w.shape)}")
            p.copy_(w)
    return field, leaves
