"""Exponential-backoff retry (counterpart of
`deeplearning4j_tpu/util/retry.py`): `with_retries`, and `RetryError` when
the attempts run out. `checkpoint/manager.py` retries its writes with it,
so that a transient storage error does not end a training run.

One policy, the reference's defaults: `TRIES` attempts; after attempt `a`
(0-based) a sleep uniform in [0, min(MAX_S, BASE_S * 2^a)] (full jitter).

Free of torch and of CUDA: the checkpoint writer's thread calls it.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type, TypeVar

T = TypeVar("T")

TRIES = 5
BASE_S = 0.1
MAX_S = 5.0


class RetryError(Exception):
    """All attempts failed; `last` is the final cause."""

    def __init__(self, message: str, last: Optional[BaseException] = None):
        super().__init__(message)
        self.last = last


def with_retries(fn: Callable[[], T], *,
                 retry_on: Tuple[Type[BaseException], ...] = (Exception,),
                 describe: str = "operation") -> T:
    """Call `fn` until it returns, an exception outside `retry_on` escapes,
    or `TRIES` attempts have failed (`RetryError`)."""
    last: Optional[BaseException] = None
    for attempt in range(TRIES):
        try:
            return fn()
        except retry_on as exc:
            last = exc
            if attempt + 1 < TRIES:
                time.sleep(min(MAX_S, BASE_S * 2.0 ** attempt)
                           * random.random())
    raise RetryError(f"{describe} failed after {TRIES} attempts: {last!r}",
                     last)
