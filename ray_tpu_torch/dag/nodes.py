"""DAG node types (reference: python/ray/dag/dag_node.py,
class_node.py ClassMethodNode, input_node.py InputNode).

``actor.method.bind(*args)`` builds a ClassMethodNode; args may be the
InputNode, other nodes, or plain constants. ``node.experimental_compile()``
compiles the graph rooted at that node.

The port's copy of ``ray_tpu/dag/nodes.py``: importing
``ray_tpu_torch.dag`` gives the port's ``ActorMethod`` its ``.bind``.
"""
from __future__ import annotations

from typing import Any


class DAGNode:
    def experimental_compile(self, max_inflight: int = 2):
        from .compiled import CompiledDAG
        return CompiledDAG(self, max_inflight=max_inflight)


class InputNode(DAGNode):
    """The driver-supplied input (one per DAG; context-manager form
    mirrors the reference API)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __repr__(self):
        return "InputNode()"


class ClassMethodNode(DAGNode):
    def __init__(self, actor, method_name: str, args: tuple):
        self.actor = actor
        self.method_name = method_name
        self.args = args

    def __repr__(self):
        return (f"ClassMethodNode({self.actor._class_name}."
                f"{self.method_name})")


class _BoundMethodBinder:
    """Gives ActorMethod a .bind() without importing dag into core."""

    @staticmethod
    def bind(actor_method, *args) -> ClassMethodNode:
        return ClassMethodNode(actor_method._handle, actor_method._name,
                               args)


def _install_bind():
    """Attach .bind to core ActorMethod (kept out of core/actor.py so the
    core has no dag dependency)."""
    from ..core.actor import ActorMethod

    def bind(self, *args: Any) -> ClassMethodNode:
        return ClassMethodNode(self._handle, self._name, args)

    if not hasattr(ActorMethod, "bind"):
        ActorMethod.bind = bind


_install_bind()
