"""Public Serve API: @deployment, bind, run, status, shutdown.

Counterpart of ``ray_tpu/serve/api.py`` (reference parity:
python/ray/serve/api.py run :691, the deployment decorator and the
Application/BuiltApplication model, and serve/deployment.py).
Deployments are declarative specs; ``.bind()`` composes them into an
application DAG whose non-ingress nodes are injected into their parents
as handles (reference: model composition via handle passing).

The port has no runtime yet, so only the reference's local testing mode
runs an application: ``run(app, local_testing_mode=True)`` builds it in
this process (``local_mode.py``). Cluster Serve — the controller,
replica actors, the HTTP proxy and ``update_user_config`` — waits for
the runtime and raises ``NotImplementedError`` instead of running
anything in its place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

_CLUSTER_NOT_PORTED = (
    "cluster Serve (controller, replica actors, HTTP proxy) is not ported "
    "to ray_tpu_torch yet; run the application in process with "
    "serve.run(app, local_testing_mode=True)")


@dataclasses.dataclass
class AutoscalingConfig:
    """(reference: serve/config.py AutoscalingConfig)"""
    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 0.5
    downscale_delay_s: float = 2.0


@dataclasses.dataclass
class DeploymentSpec:
    name: str
    func_or_class: Any
    num_replicas: int = 1
    max_ongoing_requests: int = 16
    ray_actor_options: dict = dataclasses.field(default_factory=dict)
    autoscaling_config: Optional[AutoscalingConfig] = None
    init_args: tuple = ()
    init_kwargs: dict = dataclasses.field(default_factory=dict)
    # pushed to the instance's reconfigure(user_config) when it is built
    user_config: Any = None
    # MPMD stage role within the app (e.g. "prefill"/"decode"), read by
    # the reference's controller to pair role groups; kept for its spec
    role: Optional[str] = None


class Application:
    """A bound deployment DAG; `ingress` is the root (reference:
    serve/_private/build_app.py BuiltApplication)."""

    def __init__(self, ingress: "BoundDeployment"):
        self.ingress = ingress

    def specs(self) -> list[DeploymentSpec]:
        out: dict[str, DeploymentSpec] = {}

        def visit(node: BoundDeployment):
            if node.spec.name in out:
                return
            out[node.spec.name] = node.spec
            for dep in node.children():
                visit(dep)
        visit(self.ingress)
        return list(out.values())


class BoundDeployment:
    def __init__(self, spec: DeploymentSpec, args: tuple, kwargs: dict):
        self.spec = dataclasses.replace(spec, init_args=args,
                                        init_kwargs=kwargs)

    def children(self) -> list["BoundDeployment"]:
        found = []
        for a in list(self.spec.init_args) + list(
                self.spec.init_kwargs.values()):
            if isinstance(a, BoundDeployment):
                found.append(a)
        return found


class Deployment:
    """Declarative deployment template (reference: serve/deployment.py
    Deployment). Call .bind(*init_args) to place it in an application."""

    def __init__(self, spec: DeploymentSpec):
        self._spec = spec

    @property
    def name(self) -> str:
        return self._spec.name

    def options(self, **kwargs) -> "Deployment":
        allowed = {"name", "num_replicas", "max_ongoing_requests",
                   "ray_actor_options", "autoscaling_config",
                   "user_config", "role"}
        bad = set(kwargs) - allowed
        if bad:
            raise ValueError(f"unknown deployment options {sorted(bad)}")
        return Deployment(dataclasses.replace(self._spec, **kwargs))

    def bind(self, *args, **kwargs) -> Application:
        """Returns an Application rooted at this deployment. Bound child
        applications passed as args become handles at runtime."""
        args = tuple(a.ingress if isinstance(a, Application) else a
                     for a in args)
        kwargs = {k: (v.ingress if isinstance(v, Application) else v)
                  for k, v in kwargs.items()}
        return Application(BoundDeployment(self._spec, args, kwargs))


def deployment(_func_or_class=None, *, name: Optional[str] = None,
               num_replicas: int = 1, max_ongoing_requests: int = 16,
               ray_actor_options: Optional[dict] = None,
               autoscaling_config: Optional[dict | AutoscalingConfig] = None,
               user_config: Any = None, role: Optional[str] = None,
               **_ignored) -> Any:
    """@serve.deployment decorator (reference: serve/api.py:deployment)."""
    if isinstance(autoscaling_config, dict):
        autoscaling_config = AutoscalingConfig(**autoscaling_config)

    def wrap(fc):
        n = num_replicas
        if n == "auto":
            n = 1
        return Deployment(DeploymentSpec(
            name=name or getattr(fc, "__name__", "deployment"),
            func_or_class=fc,
            num_replicas=n,
            max_ongoing_requests=max_ongoing_requests,
            ray_actor_options=ray_actor_options or {},
            autoscaling_config=autoscaling_config,
            user_config=user_config,
            role=role,
        ))
    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap


# ---------------------------------------------------------------------------
# run / status / shutdown
# ---------------------------------------------------------------------------

def run(app: Application, *, name: str = "default",
        route_prefix: Optional[str] = "/", blocking: bool = False,
        http_port: Optional[int] = None,
        num_proxies: Optional[int] = None,
        local_testing_mode: bool = False,
        _local_testing_mode: bool = False):
    """Deploy an application; returns the ingress handle (reference:
    serve/api.py:691). With ``local_testing_mode=True`` (or the
    reference's ``_local_testing_mode`` spelling) the whole application
    runs in this process (``local_mode.build_local_app``). Without it,
    raises ``NotImplementedError``: cluster Serve is not ported, and a
    local app is never built in its place. ``route_prefix``,
    ``blocking``, ``http_port`` and ``num_proxies`` are the cluster
    deploy's."""
    from ..core.usage import record_library_usage
    record_library_usage("serve")
    if local_testing_mode or _local_testing_mode:
        from .local_mode import build_local_app
        return build_local_app(app, name)
    raise NotImplementedError(_CLUSTER_NOT_PORTED)


def get_app_handle(name: str = "default"):
    """The ingress handle of the local app ``name``; raises
    ``NotImplementedError`` for any other (a cluster app is looked up in
    the controller, which is not ported)."""
    from .local_mode import get_local_app
    local = get_local_app(name)
    if local is not None:
        return local
    raise NotImplementedError(f"no local app {name!r}: "
                              + _CLUSTER_NOT_PORTED)


def update_user_config(app: str, deployment_name: str,
                       user_config: Any) -> None:
    """The reference pushes a new user_config to a deployment's live
    cluster replicas; there are none without the runtime, so this
    raises ``NotImplementedError``."""
    raise NotImplementedError(_CLUSTER_NOT_PORTED)


def status() -> dict:
    """Cluster applications by name: always none, as the reference
    reports when no controller runs (local apps are not listed there
    either)."""
    return {"applications": {}}


def delete(name: str = "default") -> None:
    from .local_mode import delete_local_app
    delete_local_app(name)


def shutdown() -> None:
    from .local_mode import _REGISTRY
    _REGISTRY.clear()
