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
converts a zip. The reference's `adapters` (LoRA deltas, ROADMAP A.12) and
`quantize` (int8, A.7) are not in the port yet.
"""

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
