"""Gather of 32-bit words from a small table: the gather floor of one hash
level.

``table_gather`` (K8) replaces the Pallas kernel ``p_gather`` of
``scripts/bench_hash.py`` (``vmem_gather_kernel``): ``out[i] =
table[idx[i]]`` from a table held in fast memory. On the TPU that is a
serial walk over a table resident in VMEM; the CUDA kernel
(``csrc/table_gather.cu``) walks the indices with a grid sized from the
card, four indices per thread and step with their table reads in flight
together, from a table that stays in L2. ``scripts/bench_hash_torch.py``
measures it beside PyTorch's own indexing. The wrapper takes the plain
twin for CPU tensors only; for CUDA tensors it launches the kernel or
raises. It counts its launches in ``table_gather.launches``.
"""

from __future__ import annotations

import torch

from .. import _build


def table_gather_plain(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """K8's twin: PyTorch indexing."""
    return table[idx.long()]


def table_gather(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for (N,) int32 ``idx`` in [0, T) and a (T,) int32
    ``table`` (K8; the plain twin for CPU tensors). Returns (N,) int32.

    Any contiguous ``idx`` is taken as it lies, a view such as ``idx[1:]``
    included: the kernel reads 16 bytes of indices at a time where the
    pointer allows and word by word where it does not. On the card an index
    outside [0, T) is clamped into the table; the twin indexes as PyTorch
    does (a negative index counts from the end, one beyond the table
    raises)."""
    if idx.device.type == "cpu":
        return table_gather_plain(idx, table)
    name = "table_gather"
    if idx.dim() != 1 or table.dim() != 1:
        raise ValueError(
            f"{name}: idx and table must be 1-D, got {tuple(idx.shape)} and "
            f"{tuple(table.shape)}"
        )
    N, T, dev = idx.shape[0], table.shape[0], idx.device
    out = torch.empty((N,), dtype=torch.int32, device=dev)
    ptrs = (
        _build.cuda_ptr(name, "idx", idx, torch.int32, (N,), dev),
        _build.cuda_ptr(name, "table", table, torch.int32, (T,), dev),
    )
    _build.launch(name, "nerfacc_table_gather", dev, *ptrs, out.data_ptr(),
                  N, T)
    table_gather.launches += 1
    return out


table_gather.launches = 0
