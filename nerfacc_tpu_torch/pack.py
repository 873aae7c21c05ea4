"""Packed <-> dense sample layouts (PyTorch port of :mod:`nerfacc_tpu.pack`).

Variable-length per-ray samples live in flat buffers with either
``ray_indices`` (the ray of each sample) or ``packed_info`` (each ray's
``[start, count]``). The buffers have a static capacity, as in the JAX
package: a packed buffer has a caller-chosen length and a validity mask,
a dense one ``n_samples`` slots per ray and a mask. No function reads a
value back to the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .scan import segment_sum


def _info(counts: torch.Tensor) -> torch.Tensor:
    """(n_rays, 2) int32 ``[start, count]`` from per-ray counts."""
    counts = counts.to(torch.int32)
    cum = torch.cumsum(counts, dim=0, dtype=torch.int32)
    return torch.stack([cum - counts, counts], dim=-1)


def pack_info(ray_indices: torch.Tensor, n_rays: int,
              masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``ray_indices`` (n_samples,) sorted -> ``packed_info`` (n_rays, 2)
    int32 ``[start, count]``; samples where ``masks`` is False are not
    counted."""
    ones = torch.ones_like(ray_indices, dtype=torch.int32)
    if masks is not None:
        ones = torch.where(masks, ones, torch.zeros_like(ones))
    return _info(segment_sum(ones, ray_indices, n_rays))


def unpack_info(packed_info: torch.Tensor, n_samples: int) -> torch.Tensor:
    """``packed_info`` (n_rays, 2) -> ``ray_indices`` (n_samples,) int32.

    Each non-empty ray marks its first sample with ``id + 1`` and a
    running max fills forward; where empty rays share a start, the largest
    id (the live one) wins. Samples past the last ray's get ``n_rays -
    1``: track validity with a mask, not with the indices.
    """
    n_rays = packed_info.shape[0]
    starts, counts = packed_info[:, 0], packed_info[:, 1]
    ids = torch.arange(1, n_rays + 1, dtype=torch.int32,
                       device=packed_info.device)
    # empty rays and starts past the buffer mark the extra last entry
    safe = torch.where(counts > 0, starts, torch.full_like(starts, n_samples))
    safe = torch.clamp(safe, max=n_samples).long()
    marks = torch.zeros(n_samples + 1, dtype=torch.int32,
                        device=packed_info.device)
    marks.scatter_reduce_(0, safe, ids, "amax")
    ray_ids = torch.cummax(marks[:-1], dim=0).values - 1
    return torch.clamp(ray_ids, 0, n_rays - 1).to(torch.int32)


def unpack_info_to_mask(packed_info: torch.Tensor,
                        n_samples: int) -> torch.Tensor:
    """Dense (n_rays, n_samples) mask: slot j of ray r is live when ``j <
    count[r]``."""
    cols = torch.arange(n_samples, dtype=torch.int32,
                        device=packed_info.device)
    return cols[None, :] < packed_info[:, 1:2]


def pack_data(
    data: torch.Tensor, mask: torch.Tensor, n_samples: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack dense (n_rays, S, D) data into a flat buffer of static capacity
    ``n_samples`` (default ``n_rays * S``).

    The live entries keep their order; past the capacity they are dropped.
    Returns ``(packed (n_samples, D), packed_info (n_rays, 2), valid
    (n_samples,))``: padding rows are zero, ``packed_info`` counts every
    live entry (dropped ones too). Differentiable in ``data``.
    """
    n_rays, S, D = data.shape
    total = n_rays * S
    if n_samples is None:
        n_samples = total
    flat = mask.reshape(-1)
    # the k-th live entry goes to row k; the rest write the extra last row
    rank = torch.cumsum(flat, dim=0) - 1
    dest = torch.where(flat & (rank < n_samples), rank,
                       torch.full_like(rank, n_samples))
    sel = torch.full((n_samples + 1,), total, dtype=torch.int64,
                     device=data.device)
    sel.scatter_(0, dest, torch.arange(total, device=data.device))
    sel = sel[:n_samples]
    valid = sel < total
    rows = data.reshape(total, D)[torch.clamp(sel, max=total - 1)]
    packed = torch.where(valid[:, None], rows, torch.zeros_like(rows))
    return packed, _info(mask.sum(dim=-1)), valid


def unpack_data(packed_info: torch.Tensor, data: torch.Tensor,
                n_samples: int) -> torch.Tensor:
    """Flat (N, D) data -> dense (n_rays, n_samples, D), zero-padded.
    Differentiable in ``data`` (the gradient gathers back the live
    slots)."""
    N = data.shape[0]
    starts, counts = packed_info[:, 0:1], packed_info[:, 1:2]
    cols = torch.arange(n_samples, dtype=torch.int32,
                        device=packed_info.device)[None, :]
    idx = torch.clamp(starts + cols, 0, N - 1).long()
    dense = data[idx]
    valid = (cols < counts)[..., None]
    return torch.where(valid, dense, torch.zeros_like(dense))
