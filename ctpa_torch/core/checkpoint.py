"""Checkpoint / resume (port of ``ctpa/core/checkpoint.py``).

ctpa keeps a step-indexed orbax store; the port keeps the methods the
CLIP trainer uses on ``torch.save``/``torch.load``: one ``<step>/state.pt``
per step under the directory, the newest ``max_to_keep`` kept.  Writes are
synchronous, so ``wait`` and ``close`` have nothing to do.  A step may
carry JSON metadata (``metadata.json`` beside its state), as ctpa's.

The report trainer's steps hold only the tensors it trains; the frozen base
they were trained on is written once per run beside them, as ``base.pt``
in the same directory (``save_base``; ``cli/train_report.py``), where
``cli/generate_report.py`` and ``cli/export_serving.py`` read it
(``load_base``).  ctpa writes the whole tree into every step instead.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import torch

_STATE = "state.pt"
_METADATA = "metadata.json"
BASE = "base.pt"


def save_base(directory: str, state: dict) -> str:
    """Write a run's frozen base (a ``state_dict``) as ``<directory>/base.pt``;
    returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(os.path.abspath(directory), BASE)
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def load_base(directory: str, map_location=None) -> dict:
    """The frozen base written by ``save_base`` into ``directory``.  A
    directory without one raises FileNotFoundError naming the file: a
    trained step alone does not make a model."""
    path = os.path.join(os.path.abspath(directory), BASE)
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path}: no frozen base beside the checkpoints (the report "
                                "trainer's steps hold only the trained tensors)")
    return torch.load(path, map_location=map_location, weights_only=True, mmap=True)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def save(self, step: int, state: Any, metadata: Optional[dict] = None,
             force: bool = False) -> None:
        """Write ``state`` (anything ``torch.save`` takes) as step ``step``,
        with ``metadata`` as JSON beside it; an existing step is overwritten
        only with ``force``."""
        path = self._dir(step)
        if os.path.exists(path) and not force:
            raise FileExistsError(f"checkpoint step {step} exists in {self.directory}")
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, _STATE))
        if metadata is not None:
            with open(os.path.join(tmp, _METADATA), "w") as f:
                json.dump(metadata, f)
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._dir(old))

    def restore(self, step: Optional[int] = None, map_location=None) -> Any:
        """The state saved at ``step`` (the latest by default), or None when
        there is none; the caller loads it into its own objects."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(os.path.join(self._dir(step), _STATE), map_location=map_location,
                          weights_only=False)

    def restore_metadata(self, step: Optional[int] = None) -> Optional[dict]:
        """The JSON metadata saved beside ``step`` (the latest by default), or
        None when there is none."""
        step = self.latest_step() if step is None else step
        path = None if step is None else os.path.join(self._dir(step), _METADATA)
        if path is None or not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        return sorted(int(name) for name in os.listdir(self.directory) if name.isdigit()
                      and os.path.exists(os.path.join(self.directory, name, _STATE)))

    def wait(self) -> None:
        pass

    def close(self) -> None:
        pass
