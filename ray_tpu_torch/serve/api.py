"""Public Serve API: @deployment, bind, run, status, shutdown.

Counterpart of ``ray_tpu/serve/api.py`` (reference parity:
python/ray/serve/api.py run :691, the deployment decorator and the
Application/BuiltApplication model, and serve/deployment.py).
Deployments are declarative specs; ``.bind()`` composes them into an
application DAG whose non-ingress nodes are injected into their parents
as DeploymentHandles (reference: model composition via handle passing).

``run`` deploys on the port's runtime: a singleton controller actor
reconciles the specs into replica actors (``controller.py``), and a
replica that asks for ``ray_actor_options={"num_gpus": n}`` leases n
whole devices of its node. With ``local_testing_mode=True`` the
application is built in this process instead (``local_mode.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from .handle import DeploymentHandle

CONTROLLER_NAME = "rtpu:serve:controller"


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
    # pushed to replicas' reconfigure(user_config) at boot and on
    # update_user_config — lightweight updates without restarts
    user_config: Any = None
    # MPMD stage role within the app (e.g. "prefill"/"decode"): the
    # controller pairs same-app role groups after reconcile — each
    # prefill replica gets a sealed KV ring to its paired decode
    # replica (the reference's llm/pd_disagg.py channel handoff)
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

def _ray():
    import ray_tpu_torch
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()
    return ray_tpu_torch


def _controller(create: bool = True):
    ray = _ray()
    from .controller import ServeController
    try:
        return ray.get_actor(CONTROLLER_NAME)
    except ValueError:
        if not create:
            raise
    cls = ray.remote(ServeController)
    return cls.options(name=CONTROLLER_NAME, max_concurrency=512).remote()


def _check_actor_options(specs: list[DeploymentSpec]) -> None:
    """The port's runtime schedules whole GPUs (``num_gpus``); a spec
    that still asks for the reference's ``num_tpus`` would start a
    replica with no device lease, so it is refused before anything
    deploys."""
    for spec in specs:
        if "num_tpus" in spec.ray_actor_options:
            raise ValueError(
                f"deployment {spec.name!r} asks for num_tpus; the port's "
                f"runtime leases GPUs: use ray_actor_options="
                f"{{'num_gpus': n}}")


def run(app: Application, *, name: str = "default",
        route_prefix: Optional[str] = "/", blocking: bool = False,
        http_port: Optional[int] = None,
        num_proxies: Optional[int] = None,
        local_testing_mode: bool = False,
        _local_testing_mode: bool = False) -> DeploymentHandle:
    """Deploy an application; returns the ingress handle
    (reference: serve/api.py:691). With ``local_testing_mode=True`` the
    whole application runs in-process with no cluster — unit-test speed
    for composition/async/streaming logic (reference:
    serve/_private/local_testing_mode.py; also accepted under the
    reference's ``_local_testing_mode`` spelling).

    ``num_proxies`` (default cfg.serve_num_proxies) scales the HTTP
    front door: the controller keeps N proxy actors alive on ports
    http_port..http_port+N-1, each applying SLO-aware admission control
    from the shared route table (serve/frontdoor/). A deployment whose
    ``ray_actor_options`` name ``num_tpus`` raises ``ValueError``."""
    import cloudpickle
    from ..core.usage import record_library_usage
    record_library_usage("serve")
    if local_testing_mode or _local_testing_mode:
        from .local_mode import build_local_app
        return build_local_app(app, name)
    specs = app.specs()
    _check_actor_options(specs)
    # a cluster deploy supersedes any local-mode app of the same name —
    # otherwise get_app_handle/delete keep shadowing the cluster app with
    # the stale in-process one
    from .local_mode import delete_local_app
    delete_local_app(name)
    ray = _ray()
    ctrl = _controller()
    specs_blob = cloudpickle.dumps(
        (specs, app.ingress.spec.name, route_prefix))
    ray.get(ctrl.deploy_application.remote(name, specs_blob, http_port,
                                           num_proxies))
    handle = DeploymentHandle(app.ingress.spec.name, name, ctrl)
    if blocking:  # pragma: no cover - interactive use
        import time
        while True:
            time.sleep(1)
    return handle


def get_app_handle(name: str = "default") -> DeploymentHandle:
    from .local_mode import get_local_app
    local = get_local_app(name)
    if local is not None:
        return local
    ray = _ray()
    ctrl = _controller(create=False)
    ingress = ray.get(ctrl.get_ingress.remote(name))
    return DeploymentHandle(ingress, name, ctrl)


def update_user_config(app: str, deployment_name: str,
                       user_config: Any) -> None:
    """Push a new user_config to a deployment's live replicas without
    restarting them (reference: lightweight config updates via
    reconfigure())."""
    ray = _ray()
    ctrl = _controller(create=False)
    ray.get(ctrl.update_user_config.remote(app, deployment_name,
                                           user_config))


def status() -> dict:
    ray = _ray()
    try:
        ctrl = _controller(create=False)
    except ValueError:
        return {"applications": {}}
    return ray.get(ctrl.status.remote())


def delete(name: str = "default") -> None:
    import ray_tpu_torch

    from .local_mode import delete_local_app
    delete_local_app(name)
    if not ray_tpu_torch.is_initialized():
        # nothing cluster-side to delete — and NEVER boot a whole cluster
        # just to tear down an app
        return
    ray = ray_tpu_torch
    try:
        ctrl = _controller(create=False)
    except ValueError:
        return
    ray.get(ctrl.delete_application.remote(name))


def _await_released(ray, name: str, timeout_s: float = 30.0) -> None:
    """Wait until the killed actor ``name`` is unregistered: a kill is
    observed asynchronously, and a ``run`` right after ``shutdown`` must
    start a new controller, not look up the dying one."""
    import time
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            ray.get_actor(name)
        except ValueError:
            return
        time.sleep(0.02)


def shutdown() -> None:
    """Stop the gRPC proxy, every application, the proxy fleet and the
    controller; returns once their names are released."""
    import ray_tpu_torch

    from .local_mode import _REGISTRY
    _REGISTRY.clear()
    if not ray_tpu_torch.is_initialized():
        return  # nothing cluster-side to stop; never BOOT one to shut down
    ray = _ray()
    try:
        gp = ray.get_actor("rtpu:serve:grpc-proxy")
        try:
            ray.get(gp.stop.remote())
        except Exception:
            pass  # proxy dying; kill below finishes it
        ray.kill(gp)
        _await_released(ray, "rtpu:serve:grpc-proxy")
    except ValueError:
        pass
    try:
        ctrl = _controller(create=False)
    except ValueError:
        return
    try:
        ray.get(ctrl.shutdown.remote())
    except Exception:
        pass  # controller dying; kill below finishes it
    try:
        ray.kill(ctrl)
    except Exception:
        pass  # already dead
    _await_released(ray, CONTROLLER_NAME)
