"""Generation serving: the continuous batcher over a GenerationSession."""

from .batcher import CircuitBreaker, Overloaded, Unavailable  # noqa: F401
from .generation import (ContinuousBatcher, GenerationConfig,  # noqa: F401
                         GenerationServingModel,
                         build_demo_generation_model)
