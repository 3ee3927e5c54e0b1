"""Input types for shape inference (counterpart of
`deeplearning4j_tpu/nn/conf/inputs.py`): the feed-forward `[batch, size]`
and recurrent `[batch, time, size]` kinds that `MultiLayerConfiguration.
build` infers `n_in` from. The convolutional kinds come with the
preprocessors (ROADMAP A.2)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class InputType:
    kind: str = "ff"  # ff | rnn
    size: int = 0
    timeseries_length: Optional[int] = None  # rnn (None = variable)

    @staticmethod
    def feed_forward(size: int) -> "InputType":
        return InputType(kind="ff", size=size)

    @staticmethod
    def recurrent(size: int,
                  timeseries_length: Optional[int] = None) -> "InputType":
        return InputType(kind="rnn", size=size,
                         timeseries_length=timeseries_length)

    def flat_size(self) -> int:
        return self.size

    @staticmethod
    def from_dict(d) -> Optional["InputType"]:
        if d is None:
            return None
        kind = d.get("kind", "ff")
        if kind not in ("ff", "rnn"):
            raise NotImplementedError(
                f"input type {kind!r} is not in the port yet: it comes with "
                "the cnn preprocessors (ROADMAP A.2)")
        return InputType(kind=kind, size=d.get("size", 0),
                         timeseries_length=d.get("timeseries_length"))
