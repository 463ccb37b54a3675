"""Async continuous-batching serving and the disaggregated multi-replica
layer over it (counterpart of ``deepspeed_tpu/serving``): the
``AsyncInferenceServer`` front end, the prefix-affinity
``InferenceRouter`` with a ``PrefillEngine`` whose prompts migrate to the
decode replicas as KV block sets, and the online ``ServingController``."""

from .config import (ControllerConfig, DisaggregationConfig,  # noqa: F401
                     HealthConfig, RouterConfig, ServingConfig)
from .controller import (Action, ServingController,  # noqa: F401
                         Signals, read_server_signals)
from .router import (ROUTER_COUNTER_KEYS, InferenceRouter,  # noqa: F401
                     PrefillEngine, RoutedHandle)
from .server import (AsyncInferenceServer, RequestCancelled,  # noqa: F401
                     RequestFailed, RequestHandle)
