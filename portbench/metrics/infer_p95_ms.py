"""95th percentile of batch latency, host start to outputs on the host."""
from portbench.readers import p95_ms as read  # noqa: F401
