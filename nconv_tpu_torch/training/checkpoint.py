"""Per-epoch, resumable checkpoints on ``torch.save``.

Every saved epoch is one file ``epoch_<n>.pt`` in the directory, holding
``{"state": ..., "meta": ...}``: ``state`` the tensors to restore (model
and optimizer state dicts), ``meta`` plain values (history, best val loss,
scheduler state). The newest ``keep`` epochs are retained. The best
variables so far live beside them in ``best_variables.pt``.
:func:`save_best` writes a run's best state dict to one file of the name
given, which :func:`load_best` reads (the command line's checkpoints).
Each file is written to a temporary name and renamed, so a killed run
leaves whole files only. Files load with ``weights_only=True``. The JAX
package's orbax layout is not read or written.
"""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any

import torch

_EPOCH = re.compile(r"epoch_(\d+)\.pt$")


def _save(obj: Any, path: Path) -> None:
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _load(path: Path) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def _epochs(self) -> list[int]:
        return sorted(int(m.group(1)) for p in self.directory.iterdir()
                      if (m := _EPOCH.match(p.name)))

    def _path(self, epoch: int) -> Path:
        return self.directory / f"epoch_{epoch:06d}.pt"

    def save(self, epoch: int, state: dict, meta: dict | None = None) -> None:
        _save({"state": state, "meta": meta or {}}, self._path(epoch))
        for old in self._epochs()[:-self.keep]:
            self._path(old).unlink(missing_ok=True)

    def latest_epoch(self) -> int | None:
        epochs = self._epochs()
        return epochs[-1] if epochs else None

    def restore(self, epoch: int | None = None):
        """``(state, meta)`` of ``epoch`` (default the latest), or None."""
        epoch = self.latest_epoch() if epoch is None else epoch
        if epoch is None:
            return None
        ckpt = _load(self._path(epoch))
        return ckpt["state"], ckpt["meta"]

    @property
    def _best_path(self) -> Path:
        return self.directory / "best_variables.pt"

    def save_best_variables(self, variables: dict) -> None:
        """Keep the best-validation model beside the epochs, so a resumed run
        still returns the true best if no later epoch improves."""
        _save(variables, self._best_path)

    def load_best_variables(self) -> dict | None:
        return _load(self._best_path) if self._best_path.exists() else None


def save_best(directory: str | os.PathLike, name: str, state: dict) -> str:
    """Write a best-model state dict to ``<directory>/<name>``; returns the
    path."""
    path = Path(directory).resolve() / name
    path.parent.mkdir(parents=True, exist_ok=True)
    _save(state, path)
    return str(path)


def load_best(path: str | os.PathLike) -> dict:
    """The state dict :func:`save_best` wrote (CPU tensors)."""
    return _load(Path(path))
