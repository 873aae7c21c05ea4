"""Multiresolution hash encoding (Instant-NGP) (PyTorch port of
:mod:`nerfacc_tpu.models.hash_encoding`).

Per level, a point's eight surrounding grid corners are looked up in that
level's table of T entries and blended trilinearly. Levels whose dense grid
fits the table, ``(res + 1)^3 <= T``, are indexed densely with stride
``res + 1``; the others through the xor-of-primes spatial hash
``(x * 1) ^ (y * 2654435761) ^ (z * 805459861)`` masked to ``T - 1``.

The lookup and its table-only gradient are
:func:`nerfacc_tpu_torch.ops.hash_gather.hash_encode_lookup`;
``pallas_grad=True`` sends the table gradient through the CUDA scatter
kernel (the JAX package's Pallas switch) instead of ``index_add_``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.hash_gather import hash_encode_lookup

_PRIMES = (1, 2654435761, 805459861)


def _level_resolutions(
    n_levels: int, base_resolution: int, per_level_scale: float
) -> np.ndarray:
    # N_l = floor(N_min * b^l)  (Instant-NGP Eq. 2), in float64
    return np.floor(
        base_resolution * per_level_scale ** np.arange(n_levels)
    ).astype(np.int64)


def hash_grid_indices(
    x: torch.Tensor, res: torch.Tensor, dense: torch.Tensor, n_entries: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corner indices and trilinear weights of every level.

    Args:
        x: (N, 3) f32 points in [0, 1]^3.
        res: (L,) int64 level resolutions, on ``x``'s device.
        dense: (L,) bool, the level is indexed densely.
        n_entries: T, entries per level (a power of two).

    Returns:
        ``(flat_idx, corner_w)``: (N, L * 8) int32 indices into the
        (L * T) table rows (level l's corners at columns ``l * 8 .. l * 8
        + 8``, in x-major corner order; level offset ``l * T`` added), and
        the (N, L * 8) f32 weights.

    The hash is uint32 arithmetic in the JAX package; here the products
    are taken in int64 and masked, which leaves the same low bits. The
    products are taken on the two candidate coordinates per axis before
    they are spread over the eight corners.
    """
    N, L, T = x.shape[0], res.shape[0], int(n_entries)
    dev = x.device
    res_f = res.to(x.dtype)
    xl = x[:, None, :] * res_f[None, :, None]  # (N, L, 3)
    c0 = torch.floor(xl)
    frac = xl - c0
    # the two candidates per axis: (N, L, 3, 2); at x == 1 the upper
    # corner clips to res while its weight stays
    o = torch.arange(2, device=dev)
    c = torch.minimum(
        torch.clamp(c0.to(torch.int64)[..., None] + o, min=0),
        res[None, :, None, None],
    )
    w = torch.stack([1.0 - frac, frac], dim=-1)

    stride = res + 1
    hashed = [c[:, :, a] * _PRIMES[a] for a in range(3)]
    strided = [
        c[:, :, 0] * (stride * stride)[None, :, None],
        c[:, :, 1] * stride[None, :, None],
        c[:, :, 2],
    ]
    # corner j of 8 takes candidate (j >> 2, j >> 1, j) & 1 of (x, y, z)
    j = torch.arange(8, device=dev)
    pick = [(j >> 2) & 1, (j >> 1) & 1, j & 1]

    def corners(per_axis):
        return [t[..., p] for t, p in zip(per_axis, pick)]  # 3 x (N, L, 8)

    hx, hy, hz = corners(hashed)
    dx, dy, dz = corners(strided)
    idx = torch.where(
        dense[None, :, None], dx + dy + dz, (hx ^ hy ^ hz) & (T - 1)
    )
    idx = idx + (torch.arange(L, device=dev) * T)[None, :, None]
    wx, wy, wz = corners([w[:, :, a] for a in range(3)])
    corner_w = (wx * wy * wz).to(torch.float32)
    return (
        idx.to(torch.int32).reshape(N, L * 8),
        corner_w.reshape(N, L * 8),
    )


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
        if gather_mode == "per_level":
            raise NotImplementedError("gather_mode='per_level' is not ported")
        if gather_mode != "packed":
            raise ValueError(f"unknown gather_mode {gather_mode!r}")
        if pallas_grad and n_features != 2:
            raise ValueError(
                "pallas_grad adds feature pairs: it needs n_features == 2, "
                f"got {n_features}"
            )
        self.n_levels, self.n_features = n_levels, n_features
        self.pallas_grad = pallas_grad
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
        with torch.no_grad():
            flat_idx, corner_w = hash_grid_indices(
                x, self._res, self._dense, self.n_entries
            )
        # F = 2 and F = 4 read the table rounded to bf16; any other F
        # reads f32
        return hash_encode_lookup(
            self.table, flat_idx, corner_w, self.n_entries,
            self.pallas_grad, packed_gather=self.n_features in (2, 4),
        )
