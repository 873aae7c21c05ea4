"""MLP radiance fields (PyTorch port of :mod:`nerfacc_tpu.models.mlp`).

Vanilla NeRF (positional encodings of degrees 10 and 4, an 8 x 256 trunk
with a skip, a view-conditioned rgb branch) and the D-NeRF field, which
warps each point by a time-conditioned MLP before the vanilla field. The
layers are f32 ``nn.Linear``; their products run wherever PyTorch runs
them (cuBLAS on the card, in f32 unless the caller turns on TF32).

Module and parameter names follow the flax tree (``layers.i`` for flax's
``Dense_i``), so :func:`nerfacc_tpu_torch.convert.vanilla_from_flax` /
``dnerf_from_flax`` carry a flax tree over as it is.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .encoders import SinusoidalEncoder


def _dense(d_in: int, d_out: int, generator: Optional[torch.Generator],
           init: str = "xavier") -> nn.Linear:
    """An ``nn.Linear`` with flax ``Dense``'s initialisers of this module:
    ``xavier`` draws the weight uniform in ``+-sqrt(6 / (d_in + d_out))``
    (flax ``xavier_uniform``; the bound is symmetric in the two fans, so
    torch's transposed ``(out, in)`` layout keeps it), ``warp`` draws it
    uniform in ``[0, 1e-4)`` (flax ``uniform(scale=1e-4)``, the warp's
    output layer). Biases start at zero. Drawn from ``generator`` only."""
    layer = nn.utils.skip_init(nn.Linear, d_in, d_out)
    with torch.no_grad():
        if init == "xavier":
            bound = math.sqrt(6.0 / (d_in + d_out))
            layer.weight.uniform_(-bound, bound, generator=generator)
        elif init == "warp":
            layer.weight.uniform_(0.0, 1e-4, generator=generator)
        else:
            raise ValueError(f"unknown init {init!r}")
        layer.bias.zero_()
    return layer


class MLP(nn.Module):
    """Skip-connected relu MLP: after hidden layer ``i`` with ``i %
    skip_layer == 0 and i > 0`` the input is concatenated back,
    ``[h, inputs]``; then an optional linear output layer. ``out_dim`` is
    the width of what ``forward`` returns."""

    def __init__(
        self,
        input_dim: int,
        output_dim: Optional[int] = None,
        net_depth: int = 8,
        net_width: int = 256,
        skip_layer: Optional[int] = 4,
        output_enabled: bool = True,
        output_init: str = "xavier",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.net_depth, self.skip_layer = net_depth, skip_layer
        self.output_enabled = output_enabled
        self.layers = nn.ModuleList()
        d_in = input_dim
        for i in range(net_depth):
            self.layers.append(_dense(d_in, net_width, generator))
            d_in = net_width + (input_dim if self._skips(i) else 0)
        if output_enabled:
            self.layers.append(_dense(d_in, output_dim, generator,
                                      output_init))
            d_in = output_dim
        self.out_dim = d_in

    def _skips(self, i: int) -> bool:
        return (self.skip_layer is not None and i % self.skip_layer == 0
                and i > 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inputs = x
        for i in range(self.net_depth):
            x = F.relu(self.layers[i](x))
            if self._skips(i):
                x = torch.cat([x, inputs], dim=-1)
        if self.output_enabled:
            x = self.layers[self.net_depth](x)
        return x


class NerfMLP(nn.Module):
    """Trunk, sigma head and the view-conditioned rgb branch. Without a
    ``condition_dim`` the rgb branch reads the trunk directly and there is
    no bottleneck layer (flax makes none when no condition is passed)."""

    def __init__(
        self,
        input_dim: int,
        condition_dim: int = 0,
        net_depth: int = 8,
        net_width: int = 256,
        skip_layer: Optional[int] = 4,
        net_depth_condition: int = 1,
        net_width_condition: int = 128,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.base = MLP(input_dim, net_depth=net_depth, net_width=net_width,
                        skip_layer=skip_layer, output_enabled=False,
                        generator=generator)
        self.sigma_layer = _dense(self.base.out_dim, 1, generator)
        rgb_in = self.base.out_dim
        if condition_dim:
            self.bottleneck_layer = _dense(self.base.out_dim, net_width,
                                           generator)
            rgb_in = net_width + condition_dim
        self.rgb_layer = MLP(rgb_in, output_dim=3,
                             net_depth=net_depth_condition,
                             net_width=net_width_condition, skip_layer=None,
                             generator=generator)

    def query_density(self, x: torch.Tensor) -> torch.Tensor:
        return self.sigma_layer(self.base(x))

    def forward(self, x: torch.Tensor, condition=None):
        """``(raw_rgb, raw_sigma)`` before their activations."""
        h = self.base(x)
        raw_sigma = self.sigma_layer(h)
        if condition is not None:
            if condition.shape[:-1] != h.shape[:-1]:
                condition = torch.broadcast_to(
                    condition[..., None, :],
                    h.shape[:-1] + (condition.shape[-1],),
                )
            h = torch.cat([self.bottleneck_layer(h), condition], dim=-1)
        return self.rgb_layer(h), raw_sigma


class VanillaNeRFRadianceField(nn.Module):
    """Vanilla NeRF field.

    ``forward(x, condition)`` -> (rgb (N, 3) after a sigmoid, sigma (N, 1)
    after a relu), ``condition`` the view directions;
    ``query_density(x)`` -> sigma; ``query_opacity(x, step_size)`` ->
    ``query_density(x) * step_size``, the occupancy ``update_grid`` reads.
    Parameters are drawn from ``generator`` on the CPU and then moved to
    ``device`` (None: the CUDA device).
    """

    def __init__(
        self,
        net_depth: int = 8,
        net_width: int = 256,
        skip_layer: int = 4,
        net_depth_condition: int = 1,
        net_width_condition: int = 128,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        self.posi_encoder = SinusoidalEncoder(3, 0, 10, True)
        self.view_encoder = SinusoidalEncoder(3, 0, 4, True)
        self.mlp = NerfMLP(
            self.posi_encoder.latent_dim, self.view_encoder.latent_dim,
            net_depth=net_depth, net_width=net_width, skip_layer=skip_layer,
            net_depth_condition=net_depth_condition,
            net_width_condition=net_width_condition, generator=generator,
        )
        self.to(torch.device("cuda") if device is None else device)

    def query_opacity(self, x: torch.Tensor, step_size: float):
        return self.query_density(x) * step_size

    def query_density(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.mlp.query_density(self.posi_encoder(x)))

    def forward(self, x: torch.Tensor, condition=None):
        if condition is not None:
            condition = self.view_encoder(condition)
        rgb, sigma = self.mlp(self.posi_encoder(x), condition=condition)
        return torch.sigmoid(rgb), F.relu(sigma)


class DNeRFRadianceField(nn.Module):
    """Time-conditioned deformation field in front of a vanilla NeRF.

    ``warp_depth`` / ``warp_width`` / ``time_degree`` size the warp MLP
    (reference defaults 4 / 64 / 4). Its output layer starts near zero
    (weights in ``[0, 1e-4)``), so the warp starts near the identity.
    Methods take per-point times ``t`` (N, 1). Parameters are drawn from
    ``generator`` on the CPU and then moved to ``device`` (None: the CUDA
    device).
    """

    def __init__(
        self,
        warp_depth: int = 4,
        warp_width: int = 64,
        time_degree: int = 4,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        self.posi_encoder = SinusoidalEncoder(3, 0, 4, True)
        self.time_encoder = SinusoidalEncoder(1, 0, time_degree, True)
        self.warp = MLP(
            self.posi_encoder.latent_dim + self.time_encoder.latent_dim,
            output_dim=3, net_depth=warp_depth, net_width=warp_width,
            skip_layer=2, output_init="warp", generator=generator,
        )
        self.nerf = VanillaNeRFRadianceField(generator=generator,
                                             device="cpu")
        self.to(torch.device("cuda") if device is None else device)

    def _warp(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return x + self.warp(
            torch.cat([self.posi_encoder(x), self.time_encoder(t)], dim=-1)
        )

    def warp_displacement(self, x: torch.Tensor, t: torch.Tensor):
        """The warp's displacement ``w(x, t) - x``, for the regularisers."""
        return self._warp(x, t) - x

    def query_opacity(self, x: torch.Tensor, timestamps: torch.Tensor,
                      step_size: float, generator: torch.Generator):
        """Density times ``step_size`` at one training time per point,
        drawn uniformly from ``timestamps`` (T, 1) with ``generator``."""
        idxs = torch.randint(0, timestamps.shape[0], (x.shape[0],),
                             generator=generator, device=generator.device)
        t = timestamps[idxs.to(timestamps.device)]
        return self.query_density(x, t) * step_size

    def query_density(self, x: torch.Tensor, t: torch.Tensor):
        return self.nerf.query_density(self._warp(x, t))

    def forward(self, x: torch.Tensor, t: torch.Tensor, condition=None):
        return self.nerf(self._warp(x, t), condition=condition)
