"""Model savers for early stopping (counterpart of
`deeplearning4j_tpu/earlystopping/saver.py`; reference
`earlystopping/saver/`: InMemoryModelSaver, LocalFileModelSaver)."""

from __future__ import annotations

import os


class InMemoryModelSaver:
    def __init__(self):
        self._best = None
        self._latest = None

    def save_best_model(self, net, score: float) -> None:
        self._best = (net.clone(), score)

    def save_latest_model(self, net, score: float) -> None:
        self._latest = (net.clone(), score)

    def get_best_model(self):
        return self._best[0] if self._best else None

    def get_latest_model(self):
        return self._latest[0] if self._latest else None


class LocalFileModelSaver:
    """Best and latest models on disk: model zips (`format="zip"`,
    `bestModel.zip`) or committed sharded checkpoints (`format="sharded"`,
    `bestModel/`). Both commit atomically: the zip is written to `*.tmp`
    and `os.replace`d into place, so a crash mid-save leaves the previous
    file whole; the sharded store renames a fully written directory.
    Models load on `device`."""

    def __init__(self, directory: str, format: str = "zip", device="cuda"):
        if format not in ("zip", "sharded"):
            raise ValueError(
                f"format must be 'zip' or 'sharded', got {format!r}")
        self.directory = directory
        self.format = format
        self.device = device
        os.makedirs(directory, exist_ok=True)

    def _path(self, name: str) -> str:
        ext = ".zip" if self.format == "zip" else ""
        return os.path.join(self.directory, name + ext)

    def _save(self, net, name: str) -> None:
        path = self._path(name)
        if self.format == "sharded":
            from deeplearning4j_tpu_torch.checkpoint import save_checkpoint

            save_checkpoint(net, path)
            return
        from deeplearning4j_tpu_torch.util import model_serializer

        tmp = path + ".tmp"
        model_serializer.save_model(net, tmp)
        os.replace(tmp, path)

    def _load(self, name: str):
        path = self._path(name)
        if self.format == "sharded":
            from deeplearning4j_tpu_torch.checkpoint import (
                is_sharded_checkpoint,
                restore_checkpoint,
            )

            return (restore_checkpoint(path, device=self.device)
                    if is_sharded_checkpoint(path) else None)
        from deeplearning4j_tpu_torch.util import model_serializer

        return (model_serializer.load_model(path, device=self.device)
                if os.path.exists(path) else None)

    def save_best_model(self, net, score: float) -> None:
        self._save(net, "bestModel")

    def save_latest_model(self, net, score: float) -> None:
        self._save(net, "latestModel")

    def get_best_model(self):
        return self._load("bestModel")

    def get_latest_model(self):
        return self._load("latestModel")
