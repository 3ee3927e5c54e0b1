"""Typed serving errors (a copy of `deeplearning4j_tpu/serving/errors.py`,
trimmed to the statuses the port's routes can return): each failure mode
maps to exactly one HTTP status. `ReplicaDrainingError` comes with the
fleets (ROADMAP A.13)."""

from __future__ import annotations

from typing import Optional


class ServingError(Exception):
    """Base: `status` is the HTTP code; `retry_after` (seconds) adds a
    `Retry-After` header when set."""

    status = 500
    retry_after: Optional[int] = None

    def payload(self) -> dict:
        return {"error": str(self)}


class InputValidationError(ServingError):
    """Request rejected before touching the device."""

    status = 400


class ModelNotFoundError(ServingError):
    status = 404


class ModelNotReadyError(ServingError):
    """The model is still warming ("warming": callers retry rather than
    wait behind the kernels' first launches), or its warmup failed
    ("failed": no retry helps, and the response has no `Retry-After`)."""

    status = 503
    retry_after = 1

    def __init__(self, message: str, state: str = "warming"):
        super().__init__(message)
        self.state = state
        if state != "warming":
            self.retry_after = None

    def payload(self) -> dict:
        return {"error": str(self), "status": self.state}


class ServerOverloadedError(ServingError):
    """Bounded queue full: load is shed, never buffered without bound."""

    status = 503
    retry_after = 1


class RequestTimeoutError(ServingError, TimeoutError):
    """Deadline expired before completion."""

    status = 504
