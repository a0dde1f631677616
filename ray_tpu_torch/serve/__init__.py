"""ray_tpu_torch.serve — model serving.

Counterpart of ``ray_tpu.serve`` (reference parity: python/ray/serve —
controller _private/controller.py:88, deployment state machine
deployment_state.py, pow-2 router request_router/pow_2_router.py:27,
replicas replica.py:945, HTTP proxy proxy.py:709, autoscaling
autoscaling_policy.py:12, public api serve/api.py).

A singleton ServeController actor on the port's runtime reconciles
declarative deployment specs into replica actors; DeploymentHandles
route requests with power-of-two-choices over per-handle in-flight
counts and stream through sealed ring channels in the object store; a
controller-managed FLEET of aiohttp proxy actors exposes HTTP behind a
shared route table with SLO-aware admission control and a cluster-wide
prefix-cache directory (serve/frontdoor/); queue-based autoscaling
adds/removes replicas between min/max. A replica that asks for
``ray_actor_options={"num_gpus": n}`` leases n whole devices. LLM
serving lives in ray_tpu_torch.llm on top of this.

    @serve.deployment(num_replicas=2)
    class Model:
        def __call__(self, x): ...

    handle = serve.run(Model.bind(), name="app")
    out = handle.remote(x).result()

``serve.run(app, local_testing_mode=True)`` builds the application in
this process instead, with no runtime (``local_mode.py``).
"""
from .api import (
    Application,
    Deployment,
    delete,
    deployment,
    get_app_handle,
    run,
    shutdown,
    status,
    update_user_config,
)
from .batching import batch
from .context import get_multiplexed_model_id, get_request_context
from .handle import (DeploymentHandle, DeploymentResponse,
                     DeploymentResponseGenerator)
from .grpc_proxy import start_grpc_proxy
from .metrics import metrics_summary
from .multiplex import multiplexed

__all__ = [
    "Application", "Deployment", "deployment", "run", "shutdown", "delete",
    "status", "get_app_handle", "DeploymentHandle", "DeploymentResponse",
    "DeploymentResponseGenerator", "batch", "multiplexed",
    "get_multiplexed_model_id", "get_request_context", "metrics_summary",
    "start_grpc_proxy", "update_user_config",
]
