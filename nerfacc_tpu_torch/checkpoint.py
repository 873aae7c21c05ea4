"""Checkpoint and resume (PyTorch port of :mod:`nerfacc_tpu.checkpoint`).

The JAX package wraps orbax; the port needs no such package. A state is a
nest of dicts, lists and tuples of tensors and Python scalars (a field's
and an optimizer's ``state_dict``, the grid's tensors, a generator's
state, a step). ``save`` writes it with ``torch.save`` to a temporary
file in the directory and renames that into place, so a checkpoint is
either whole or absent; ``restore`` reads it back with
``weights_only=True``, which loads tensors and plain containers only.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, List, Optional

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    """Numbered checkpoints in ``directory`` (created if missing), keeping
    the newest ``max_to_keep``."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> Path:
        return self.directory / f"ckpt_{step}.pt"

    def steps(self) -> List[int]:
        """The steps of the checkpoints on disk, in ascending order."""
        found = (_NAME.match(p.name) for p in self.directory.iterdir())
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, step: int, state: Any) -> None:
        """Write ``state`` as the checkpoint of ``step`` (replacing one of
        the same step), then delete all but the newest ``max_to_keep``."""
        tmp = self.directory / f".ckpt_{step}.pt.tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-self.max_to_keep]:
            self._path(old).unlink()

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Any:
        """The state saved at ``step`` (None: the latest), on the CPU."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)

    def close(self) -> None:
        """Nothing stays open between calls; kept for the JAX package's
        interface."""
