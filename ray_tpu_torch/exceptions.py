"""Exception hierarchy.

Reference parity: python/ray/exceptions.py (RayError, RayTaskError,
WorkerCrashedError, ActorDiedError, TaskCancelledError, ObjectLostError,
GetTimeoutError, ObjectStoreFullError).
"""
from __future__ import annotations

import traceback


class RayError(Exception):
    """Base class for all framework errors."""


class RayTaskError(RayError):
    """Wraps an exception raised by user task/actor code, carrying the remote
    traceback so `ray.get` shows where the failure happened."""

    def __init__(self, function_name: str, cause: BaseException,
                 remote_tb: str | None = None):
        self.function_name = function_name
        self.cause = cause
        self.remote_tb = remote_tb or "".join(
            traceback.format_exception(type(cause), cause, cause.__traceback__))
        super().__init__(
            f"task {function_name} failed:\n{self.remote_tb}")

    def __reduce__(self):
        return (RayTaskError,
                (self.function_name, self.cause, self.remote_tb))

    def as_instanceof_cause(self) -> BaseException:
        """Return an exception that is an instance of the cause's class (so
        `except ValueError` works across the task boundary), still carrying
        the remote traceback in its message.

        Reference analog: RayTaskError.as_instanceof_cause
        (python/ray/exceptions.py).
        """
        cause = self.cause
        if isinstance(cause, RayError):
            return cause
        try:
            cls = type(cause)
            err = cls.__new__(cls)
            err.args = cause.args
            err.__cause__ = self
            return err
        except Exception:
            return self


class WorkerCrashedError(RayError):
    """The worker process executing the task died unexpectedly."""


class ActorDiedError(RayError):
    """The actor is dead (crashed, killed, or out of restarts)."""


class ActorUnavailableError(RayError):
    """The actor is temporarily unreachable (restarting)."""


class TaskCancelledError(RayError):
    """The task was cancelled."""


class ObjectLostError(RayError):
    """The object was evicted/lost and could not be reconstructed."""


class GetTimeoutError(RayError, TimeoutError):
    """`ray.get(..., timeout=...)` expired."""


class ObjectStoreFullError(RayError, MemoryError):
    """The shared-memory object store is out of space."""


class RuntimeEnvSetupError(RayError):
    """Setting up the runtime environment for a task/actor failed."""


class PlacementGroupUnavailableError(RayError):
    """Placement group cannot be scheduled with current cluster resources."""


class PendingCallsLimitExceeded(RayError):
    """An actor handle with ``max_pending_calls`` set has that many calls
    in flight (reference: ray.exceptions.PendingCallsLimitExceeded, raised
    by the actor task submitter's client-side backpressure)."""


class ExitActorSignal(BaseException):
    """Control-flow signal raised by ray_tpu_torch.exit_actor() inside an actor
    method; the worker catches it and exits the actor intentionally
    (no restart). BaseException so user ``except Exception`` blocks
    cannot swallow it — the same reason the reference's sync path raises
    SystemExit (ray.actor.exit_actor)."""
