"""Multiresolution hash encoding (Instant-NGP) (PyTorch port of
:mod:`nerfacc_tpu.models.hash_encoding`).

Per level, a point's eight surrounding grid corners are looked up in that
level's table of T entries and blended trilinearly. Levels whose dense grid
fits the table, ``(res + 1)^3 <= T``, are indexed densely with stride
``res + 1``; the others through the xor-of-primes spatial hash
``(x * 1) ^ (y * 2654435761) ^ (z * 805459861)`` masked to ``T - 1``.

On the card the whole forward is one launch of
:func:`nerfacc_tpu_torch.ops.hash_gather.hash_encode` (tables of 1, 2, 4
or 8 features); CPU tensors and any other F take its twin,
``hash_grid_indices`` and then ``hash_encode_lookup``. Both have the same
table-only gradient: ``pallas_grad=True`` sends it through the CUDA
scatter kernel (the JAX package's Pallas switch) instead of
``index_add_``. ``gather_mode="per_level"`` (on the TPU, one gather per
level for the gather's rate) reads the same values in the same layout: it
is the packed gather.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from .. import tracing
from ..ops.hash_gather import (  # hash_grid_indices: the models' export
    HASH_ENCODE_FEATURES,
    hash_encode,
    hash_encode_plain,
    hash_grid_indices,
)


def _level_resolutions(
    n_levels: int, base_resolution: int, per_level_scale: float
) -> np.ndarray:
    # N_l = floor(N_min * b^l)  (Instant-NGP Eq. 2), in float64
    return np.floor(
        base_resolution * per_level_scale ** np.arange(n_levels)
    ).astype(np.int64)


class HashEncoder(nn.Module):
    """Instant-NGP multiresolution hash encoding.

    Input (N, 3) in [0, 1]^3 -> output (N, n_levels * n_features),
    feature-major. The parameter ``table`` is (L, T, F), drawn
    uniform(-1e-4, 1e-4) from ``generator`` on the CPU and then moved to
    ``device`` (None: the CUDA device).
    """

    def __init__(
        self,
        n_levels: int = 16,
        n_features: int = 2,
        log2_hashmap_size: int = 19,
        base_resolution: int = 16,
        per_level_scale: float = 1.4472692012786865,
        pallas_grad: bool = False,
        gather_mode: str = "packed",
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        if gather_mode not in ("packed", "per_level"):
            raise ValueError(f"unknown gather_mode {gather_mode!r}")
        if pallas_grad and n_features != 2:
            raise ValueError(
                "pallas_grad adds feature pairs: it needs n_features == 2, "
                f"got {n_features}"
            )
        self.n_levels, self.n_features = n_levels, n_features
        self.pallas_grad, self.gather_mode = pallas_grad, gather_mode
        self.n_entries = 1 << log2_hashmap_size
        res = _level_resolutions(n_levels, base_resolution, per_level_scale)
        self.register_buffer("_res", torch.as_tensor(res), persistent=False)
        # dense indexing where the full grid fits
        self.register_buffer(
            "_dense", torch.as_tensor((res + 1) ** 3 <= self.n_entries),
            persistent=False,
        )
        table = torch.empty(n_levels, self.n_entries, n_features)
        table.uniform_(-1e-4, 1e-4, generator=generator)
        self.table = nn.Parameter(table)
        self.to(torch.device("cuda") if device is None else device)

    @property
    def latent_dim(self) -> int:
        return self.n_levels * self.n_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # F = 2 and F = 4 read the table rounded to bf16; any other F
        # reads f32. gather_mode "per_level" reads the same values in the
        # same layout (on the TPU, L gathers for the gather's rate), so it
        # is the packed gather here
        args = (x, self.table, self._res, self._dense, self.n_entries,
                self.pallas_grad, self.n_features in (2, 4))
        with tracing.span("encoder"):
            tracing.count("encoder_rows", x.shape[0])
            if x.is_cuda and self.n_features in HASH_ENCODE_FEATURES:
                tracing.count("encoder_kernel_rows", x.shape[0])
                return hash_encode(*args)
            return hash_encode_plain(*args)
