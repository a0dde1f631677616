"""ray_tpu_torch.serve — model serving in process.

Counterpart of ``ray_tpu.serve``: the ``@serve.deployment`` /
``.bind()`` / ``serve.run`` surface (``api.py``), ``@serve.batch``,
``@serve.multiplexed`` and the request context. Without the runtime an
application runs only in the reference's local testing mode — every
deployment an object in this process, handles dispatching over a thread
pool (``local_mode.py``):

    @serve.deployment
    class Model:
        def __call__(self, x): ...

    handle = serve.run(Model.bind(), local_testing_mode=True)
    out = handle.remote(x).result()

``serve.run`` without local mode raises ``NotImplementedError``: the
controller, replica actors, cluster handles, the HTTP and gRPC proxies
and the Serve metrics are not ported yet.
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
from .multiplex import multiplexed

__all__ = [
    "Application", "Deployment", "deployment", "run", "shutdown", "delete",
    "status", "get_app_handle", "batch", "multiplexed",
    "get_multiplexed_model_id", "get_request_context", "update_user_config",
]
