"""The host side of host-to-device staging (counterpart of
`deeplearning4j_tpu/datasets/staging.py`; only `transfer_cast` so far, the
background stager is ROADMAP A.10).

`transfer_cast(item, dtype)` casts a batch's floating features and labels
on the host to a policy's `transfer_dtype` before the engine copies them
to its device, so the copy moves fewer bytes (f32 to bf16 halves them).
Masks and integer parts (ids, image bytes) are left alone, and so are
tensors already on a device. numpy has no bfloat16, so a cast part comes
back as a CPU tensor of the transfer dtype, which the engines take as they
take an array.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet


def _cast(a, dtype: torch.dtype):
    if isinstance(a, torch.Tensor):
        if a.device.type == "cpu" and a.is_floating_point() \
                and a.dtype != dtype:
            return a.to(dtype)
        return a
    if a is None:
        return a
    arr = np.asarray(a)
    if np.issubdtype(arr.dtype, np.floating):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        return t if t.dtype == dtype else t.to(dtype)
    return a


def transfer_cast(item, transfer_dtype):
    """`item` (a DataSet or a MultiDataSet) with its floating features and
    labels cast to `transfer_dtype` (a torch dtype, or None for no cast);
    anything else passes through."""
    if transfer_dtype is None:
        return item
    if isinstance(item, MultiDataSet):
        return MultiDataSet(
            features=[_cast(f, transfer_dtype) for f in item.features],
            labels=[_cast(lab, transfer_dtype) for lab in item.labels],
            features_masks=item.features_masks,
            labels_masks=item.labels_masks)
    if isinstance(item, DataSet):
        return DataSet(_cast(item.features, transfer_dtype),
                       _cast(item.labels, transfer_dtype),
                       item.features_mask, item.labels_mask)
    return item

