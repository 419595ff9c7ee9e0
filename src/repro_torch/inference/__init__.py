from .runtime import (AdaptiveBatchController, ServedRequest,
                      ServingRuntime, SLOConfig)
from .server import (ForestServer, LMServer, MicroBatcher, Request,
                     Reservoir, ServerStats)

__all__ = ["ForestServer", "LMServer", "MicroBatcher", "Request",
           "Reservoir", "ServerStats",
           "ServingRuntime", "ServedRequest", "SLOConfig",
           "AdaptiveBatchController"]
