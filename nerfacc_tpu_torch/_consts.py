"""Small constant tensors on a device, made once and kept.

A tensor built from host values on the card is an upload: PyTorch copies
pageable memory and then waits for the stream, so each one stops the host
until the card has caught up, and a CUDA graph can capture none. The
march, the grid lookups and the encoders read their few constants (an
AABB, a grid resolution, a divisor) through :func:`constant` instead,
which uploads each distinct one once per device and dtype, from
page-locked memory and without waiting.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

_cache: Dict[Tuple, torch.Tensor] = {}


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``: a float or a
    tuple of numbers, made at the first call with these arguments and the
    same tensor after. Callers must not write to it."""
    key = (type(values), values, dtype, torch.device(device))
    t = _cache.get(key)
    if t is None:
        # never an inference tensor: autograd may save it later
        with torch.inference_mode(False):
            t = torch.tensor(values, dtype=dtype)
            if t.device != torch.device(device):
                t = t.pin_memory().to(device, non_blocking=True)
        _cache[key] = t
    return t
