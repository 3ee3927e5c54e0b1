"""Serving tier of the port: HTTP generation with continuous batching."""

from deeplearning4j_tpu_torch.serving.errors import ServingError
from deeplearning4j_tpu_torch.serving.scheduler import GenerationScheduler
from deeplearning4j_tpu_torch.serving.server import InferenceServer

__all__ = ["GenerationScheduler", "InferenceServer", "ServingError"]
