"""Input encoders (PyTorch port of :mod:`nerfacc_tpu.models.encoders`).

The sinusoidal positional encoding of vanilla NeRF. The multiresolution
hash encoding lives in :mod:`.hash_encoding`.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .. import tracing
from .._consts import constant


class SinusoidalEncoder(nn.Module):
    """NeRF positional encoding: ``[x, sin(2^i x), cos(2^i x)]`` for ``i``
    in ``[min_deg, max_deg)``, without parameters.

    The cosine half is ``sin(xb + pi / 2)`` in f32, as the JAX package
    computes it: at degree 9 ``xb`` reaches ~770, where the f32 add of
    pi / 2 rounds by up to ~3e-5 and ``cos(xb)`` would differ by as much.
    """

    def __init__(self, x_dim: int, min_deg: int, max_deg: int,
                 use_identity: bool = True):
        super().__init__()
        self.x_dim, self.min_deg, self.max_deg = x_dim, min_deg, max_deg
        self.use_identity = use_identity

    @property
    def latent_dim(self) -> int:
        return (int(self.use_identity)
                + (self.max_deg - self.min_deg) * 2) * self.x_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.max_deg == self.min_deg:
            return x
        with tracing.span("encoder"):
            scales = constant(
                tuple(2.0**i for i in range(self.min_deg, self.max_deg)),
                x.dtype, x.device,
            )
            xb = (x[..., None, :] * scales[:, None]).reshape(
                x.shape[:-1] + ((self.max_deg - self.min_deg) * self.x_dim,)
            )
            latent = torch.sin(torch.cat([xb, xb + 0.5 * math.pi], dim=-1))
            if self.use_identity:
                latent = torch.cat([x, latent], dim=-1)
            return latent
