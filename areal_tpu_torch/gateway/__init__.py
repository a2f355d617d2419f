"""The serving gateway (the counterpart of ``areal_tpu/gateway/``).

Fronts the interruptible gen fleet with an OpenAI-compatible HTTP API
backed by continuous batching, per-tenant QoS (token-bucket rate limits +
weighted fair queueing), KV-occupancy admission control, and a
telemetry-driven autoscaler that resizes the routed server set live.

Modules:

- ``qos``        — tenants, token buckets, weighted fair queue (pure)
- ``scheduler``  — continuous-batching dispatch onto gen servers
- ``api``        — /v1/completions + /v1/chat/completions (SSE + buffered)
- ``autoscaler`` — fleet-aggregate -> scale decisions -> routed-set edits
- ``brownout``   — the degradation ladder under sustained saturation
"""

from areal_tpu_torch.gateway.api import (  # noqa: F401
    ByteFallbackCodec,
    GatewayConfig,
    GatewayServer,
    HFTokenizerCodec,
    TokenCodec,
    serve_gateway,
)
from areal_tpu_torch.gateway.autoscaler import (  # noqa: F401
    Autoscaler,
    AutoscalerConfig,
    ScaleDecision,
    ScaleSignals,
    decide,
)
from areal_tpu_torch.gateway.qos import (  # noqa: F401
    TenantSpec,
    TokenBucket,
    WeightedFairQueue,
)
from areal_tpu_torch.gateway.scheduler import (  # noqa: F401
    ContinuousBatchScheduler,
    GatewayRequest,
    RateLimited,
)
