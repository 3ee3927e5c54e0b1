"""Sharded checkpoint store (counterpart of `deeplearning4j_tpu/checkpoint/`),
in three layers:

- `array_store`: each leaf's chunk files and its `index.json` entry;
- `store`: the atomic commit (`step_N.tmp/`, fsync, COMMIT manifest,
  rename) and the restore, in place into a net or into one built from the
  checkpoint's conf;
- `manager`: `CheckpointManager`, step naming, keep-last / keep-every
  retention, saves written off the training thread, `latest()` over
  committed steps only.

`legacy.load_any` opens this format or a model zip; `legacy.migrate_zip`
converts a zip; `quantize` writes the int8 serving checkpoint of a
committed one (`python -m deeplearning4j_tpu_torch.checkpoint.quantize
<src> <dst>`); `adapters` saves a net's LoRA deltas as a small committed
snapshot pinned to its base's fingerprint, and loads them back
(`save_adapter`, `load_adapter`, `base_fingerprint`).
"""

from deeplearning4j_tpu_torch.checkpoint.adapters import (
    adapter_meta,
    base_fingerprint,
    is_adapter_checkpoint,
    load_adapter,
    save_adapter,
)
from deeplearning4j_tpu_torch.checkpoint.array_store import (
    CheckpointCorruptError,
    CheckpointError,
)
from deeplearning4j_tpu_torch.checkpoint.legacy import load_any, migrate_zip
from deeplearning4j_tpu_torch.checkpoint.manager import CheckpointManager
from deeplearning4j_tpu_torch.checkpoint.store import (
    is_sharded_checkpoint,
    restore_checkpoint,
    save_checkpoint,
    verify_checkpoint,
)

__all__ = [
    "adapter_meta",
    "base_fingerprint",
    "is_adapter_checkpoint",
    "load_adapter",
    "save_adapter",
    "CheckpointCorruptError",
    "CheckpointError",
    "CheckpointManager",
    "is_sharded_checkpoint",
    "load_any",
    "migrate_zip",
    "restore_checkpoint",
    "save_checkpoint",
    "verify_checkpoint",
]
