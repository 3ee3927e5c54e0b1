"""Input types for shape inference (counterpart of
`deeplearning4j_tpu/nn/conf/inputs.py`): feed-forward `[batch, size]`,
recurrent `[batch, time, size]`, convolutional NHWC `[batch, h, w, c]` and
its flat form `cnnflat` (`[batch, h * w * c]`, h, w and c carried), from
which `MultiLayerConfiguration.build` infers each layer's `n_in` and the
preprocessors it inserts between layer families."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class InputType:
    kind: str = "ff"  # ff | rnn | cnn | cnnflat
    size: int = 0  # ff / rnn feature size (cnnflat: h * w * c)
    timeseries_length: Optional[int] = None  # rnn (None = variable)
    height: int = 0
    width: int = 0
    channels: int = 0

    @staticmethod
    def feed_forward(size: int) -> "InputType":
        return InputType(kind="ff", size=size)

    @staticmethod
    def recurrent(size: int,
                  timeseries_length: Optional[int] = None) -> "InputType":
        return InputType(kind="rnn", size=size,
                         timeseries_length=timeseries_length)

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType(kind="cnn", height=height, width=width,
                         channels=channels)

    @staticmethod
    def convolutional_flat(height: int, width: int,
                           channels: int) -> "InputType":
        return InputType(kind="cnnflat", height=height, width=width,
                         channels=channels, size=height * width * channels)

    def flat_size(self) -> int:
        if self.kind in ("ff", "rnn"):
            return self.size
        return self.height * self.width * self.channels

    def to_dict(self) -> dict:
        d = {"kind": self.kind}
        if self.kind in ("ff", "rnn"):
            d["size"] = self.size
        if self.kind == "rnn" and self.timeseries_length is not None:
            d["timeseries_length"] = self.timeseries_length
        if self.kind in ("cnn", "cnnflat"):
            d.update(height=self.height, width=self.width,
                     channels=self.channels)
        return d

    @staticmethod
    def from_dict(d) -> Optional["InputType"]:
        if d is None:
            return None
        kind = d.get("kind", "ff")
        if kind not in ("ff", "rnn", "cnn", "cnnflat"):
            raise ValueError(f"unknown input type kind {kind!r}")
        unknown = sorted(set(d) - {f.name for f in
                                   dataclasses.fields(InputType)})
        if unknown:
            raise ValueError(f"InputType has no fields {unknown}")
        return InputType(kind=kind, size=d.get("size", 0),
                         timeseries_length=d.get("timeseries_length"),
                         height=d.get("height", 0), width=d.get("width", 0),
                         channels=d.get("channels", 0))
