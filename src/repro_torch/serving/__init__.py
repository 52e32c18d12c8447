"""The port's solve-serving layer: the request-coalescing ``SolveServer``
over an LRU ``PreparedPool`` of prepared solvers, the QoS ``BatchPolicy``,
the factor ``CheckpointStore`` (the JAX package's format) and the
deterministic fault injection behind the containment ladder."""
from repro_torch.serving.checkpoint import FORMAT_VERSION, CheckpointStore, prepare_key
from repro_torch.serving.faults import (
    FaultInjector,
    FaultPlan,
    FaultRule,
    InjectedFault,
    SolveFailure,
)
from repro_torch.serving.policy import (
    AdmissionError,
    BatchPolicy,
    Priority,
    SubmitOptions,
    batch_key,
)
from repro_torch.serving.queue import (
    PoolStats,
    PreparedPool,
    RequestResult,
    ServerSession,
    ServerStats,
    SolveServer,
    matrix_fingerprint,
    replay_trace,
)

__all__ = [
    "FORMAT_VERSION",
    "AdmissionError",
    "BatchPolicy",
    "CheckpointStore",
    "FaultInjector",
    "FaultPlan",
    "FaultRule",
    "InjectedFault",
    "PoolStats",
    "PreparedPool",
    "Priority",
    "RequestResult",
    "ServerSession",
    "ServerStats",
    "SolveFailure",
    "SolveServer",
    "SubmitOptions",
    "batch_key",
    "matrix_fingerprint",
    "prepare_key",
    "replay_trace",
]
