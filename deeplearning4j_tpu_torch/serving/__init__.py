"""Serving tier of the port: `/predict` through the shape-bucket batcher,
`/generate` with continuous batching (paged KV, prefix cache, drain mode,
speculative decoding), warmup, `/health`, `/healthz`, `/metrics`."""

from deeplearning4j_tpu_torch.serving.batcher import (
    ShapeBucketBatcher,
    bucket_ladder,
    canonicalize_features,
)
from deeplearning4j_tpu_torch.serving.errors import (
    InputValidationError,
    ModelNotFoundError,
    ModelNotReadyError,
    RequestTimeoutError,
    ServerOverloadedError,
    ServingError,
)
from deeplearning4j_tpu_torch.serving.scheduler import (
    GenerationScheduler,
    prompt_bucket_ladder,
)
from deeplearning4j_tpu_torch.serving.server import InferenceServer

__all__ = ["GenerationScheduler", "InferenceServer", "InputValidationError",
           "ModelNotFoundError", "ModelNotReadyError", "RequestTimeoutError",
           "ServerOverloadedError", "ServingError", "ShapeBucketBatcher",
           "bucket_ladder", "canonicalize_features", "prompt_bucket_ladder"]
