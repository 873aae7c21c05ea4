"""Segmented scans over packed per-ray sample buffers (PyTorch port of
:mod:`nerfacc_tpu.scan`).

Layout contract, as in the JAX package: packed tensors are flat
``(n_samples,)`` with the samples of one ray contiguous and rays in
ascending order (``seg_ids`` sorted); padding entries carry ``x == 0``
(``x == 1`` for the product) and so perturb no result; ``num_segments`` is
a Python int.

Every scan is the segmented reset operator ``(fa, va) . (fb, vb) = (fa |
fb, vb if fb else va op vb)`` applied Hillis-Steele style: ``ceil(log2
n)`` steps of ``torch.where`` over the whole buffer, with no host sync.
It never adds across a segment boundary, so a result's rounding error is
relative to its own segment's partial sum, as in a per-ray serial loop. A
global ``cumsum`` less each segment's starting offset is not used: its
cancellation grows with the global prefix and loses late rays' precision
in f32. Sums and products accumulate in at least f32.
"""

from __future__ import annotations

import torch


def _acc(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _first_of_segment(seg_ids: torch.Tensor) -> torch.Tensor:
    first = torch.ones_like(seg_ids, dtype=torch.bool)
    first[1:] = seg_ids[1:] != seg_ids[:-1]
    return first


def _inclusive_scan(first: torch.Tensor, v: torch.Tensor, op) -> torch.Tensor:
    """Inclusive segmented scan of ``v`` under ``op``, segments starting
    where ``first`` is set."""
    n = v.shape[0]
    f = first
    d = 1
    while d < n:
        fb, vb = f[d:], v[d:]
        v = torch.cat([v[:d], torch.where(fb, vb, op(v[:-d], vb))])
        f = torch.cat([f[:d], fb | f[:-d]])
        d *= 2
    return v


def _shift_in_segment(x, first, identity):
    """``x[i - 1]`` inside each segment, ``identity`` at its start."""
    shifted = torch.cat([x[:1], x[:-1]])  # x[0] never shows: first[0] is set
    return torch.where(first, torch.full_like(x, identity), shifted)


def segment_sum(x: torch.Tensor, seg_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum ``x`` (N, ...) per segment into (num_segments, ...).

    ``index_add_``: on CUDA tensors its adds land in atomic order, so the
    last bits may differ from run to run; compare with a tolerance."""
    out = torch.zeros((num_segments,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add(0, seg_ids.long(), x)


def exclusive_segment_cumsum(x: torch.Tensor, seg_ids: torch.Tensor,
                             num_segments: int) -> torch.Tensor:
    """``out[i] = sum of x[j]`` for ``j < i`` in i's segment (CUB
    ``ExclusiveSumByKey``): an inclusive scan of ``x`` shifted by one
    inside each segment."""
    xa = _acc(x)
    first = _first_of_segment(seg_ids)
    out = _inclusive_scan(first, _shift_in_segment(xa, first, 0.0),
                          torch.add)
    return out.to(x.dtype)


def inclusive_segment_cumsum(x: torch.Tensor, seg_ids: torch.Tensor,
                             num_segments: int) -> torch.Tensor:
    """Inclusive per-segment cumulative sum."""
    return exclusive_segment_cumsum(x, seg_ids, num_segments) + x


def reverse_exclusive_segment_cumsum(x: torch.Tensor, seg_ids: torch.Tensor,
                                     num_segments: int) -> torch.Tensor:
    """``out[i] = sum of x[j]`` for ``j > i`` in i's segment (the
    reference backwards' reverse scans): the exclusive scan of the
    reversed buffer, reversed. Unlike the JAX package's ``total -
    inclusive prefix`` it subtracts nothing, so a suffix keeps its own
    precision."""
    out = exclusive_segment_cumsum(torch.flip(_acc(x), (0,)),
                                   torch.flip(seg_ids, (0,)), num_segments)
    return torch.flip(out, (0,)).to(x.dtype)


def exclusive_segment_cumprod(x: torch.Tensor, seg_ids: torch.Tensor,
                              num_segments: int) -> torch.Tensor:
    """``out[i] = prod of x[j]`` for ``j < i`` in i's segment (CUB
    ``ExclusiveProductByKey``). Exact products: a zero factor gives zero
    after it and never a division."""
    xa = _acc(x)
    first = _first_of_segment(seg_ids)
    out = _inclusive_scan(first, _shift_in_segment(xa, first, 1.0),
                          torch.mul)
    return out.to(x.dtype)
