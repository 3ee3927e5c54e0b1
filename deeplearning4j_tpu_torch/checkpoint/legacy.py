"""Between the sharded store and the model zip (counterpart of
`deeplearning4j_tpu/checkpoint/legacy.py`): one loader that opens either,
and a migrator.

The zip (`util/model_serializer.py`, `util/checkpoint.py`) holds the whole
flat float64 param and updater buffers; `migrate_zip` writes the same
state as a committed sharded step beside it and leaves the zip as it is.
"""

from __future__ import annotations

import os
import zipfile
from typing import Optional

from deeplearning4j_tpu_torch.checkpoint import store
from deeplearning4j_tpu_torch.checkpoint.array_store import CheckpointError


def _latest_step_dir(root: str) -> Optional[str]:
    from deeplearning4j_tpu_torch.checkpoint.manager import CheckpointManager

    return CheckpointManager(root).latest_path()


def load_any(path, device="cuda", **restore_kwargs):
    """Open the checkpoint at `path`, whatever it is: a committed sharded
    step, a manager root (its newest committed step), or a zip written by
    `save_model` or `util.checkpoint`. The net is built on `device`;
    `restore_kwargs` (`net`, `load_updater`, ...) go to the sharded
    restore."""
    path = str(path)
    if os.path.isdir(path):
        if store.is_sharded_checkpoint(path):
            return store.restore_checkpoint(path, device=device,
                                            **restore_kwargs)
        latest = _latest_step_dir(path)
        if latest is not None:
            return store.restore_checkpoint(latest, device=device,
                                            **restore_kwargs)
        raise CheckpointError(
            f"{path} is a directory but holds no committed sharded "
            "checkpoint (no COMMIT manifest; half-written .tmp saves are "
            "ignored)")
    if zipfile.is_zipfile(path):
        from deeplearning4j_tpu_torch.util import checkpoint as zip_ckpt

        return zip_ckpt.load_checkpoint(path, device=device)
    raise CheckpointError(
        f"{path} is neither a sharded checkpoint directory nor a model zip")


def migrate_zip(zip_path: str, directory: str, step: Optional[int] = None,
                device="cuda") -> str:
    """Write the zip checkpoint at `zip_path` as a committed sharded step
    under `directory` (default step: the zip's iteration), through a net
    on `device`. Returns the step's path; the zip is not changed."""
    from deeplearning4j_tpu_torch.checkpoint.manager import CheckpointManager
    from deeplearning4j_tpu_torch.util import checkpoint as zip_ckpt

    net = zip_ckpt.load_checkpoint(zip_path, device=device)
    mgr = CheckpointManager(directory, keep_last=0, async_save=False)
    return mgr.save(net, step=step)
