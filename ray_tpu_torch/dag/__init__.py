"""ray_tpu_torch.dag — compiled graphs (aDAG analog); the port's copy of
``ray_tpu.dag``.

Reference parity: ray compiled graphs (python/ray/dag/compiled_dag_node.py:808
CompiledDAG, schedule generation dag_node_operation.py:686, shared-memory
channels experimental/channel/shared_memory_channel.py over the C++ mutable
objects, experimental_mutable_object_manager.h:44).

Redesign over the object store: the reference compiles DAGs to avoid
per-call task overhead for GPU pipelines; here the same is achieved
with **sealed ring channels** (dag/channel.py): every DAG edge gets a
pair of id bases (data + ack); message ``seq`` seals at ``base[:12] + uint32(seq)``, the
consumer parks in ONE ``os_wait_sealed`` futex wait over ``{data, stop}``
and reads **zero-copy** (ids are never reused, so pinned views can't
collide with a rewrite), then retires the ring position by sealing a tiny
ack object the producer consumes before writing ``seq + ring``. Objects
stay immutable, matching the store's contract, where the reference needed
a special mutable-object type with reader/writer semaphores.
Each participating actor runs a compiled loop (installed via the internal
``__rtpu_exec__`` injection) that steps its nodes in topological order;
after compile, ``execute()`` never touches the head scheduler — the
driver writes input channels and reads output channels directly.
``cfg.dag_sealed_channels = False`` restores the legacy consume-once
polling transport (delete-and-recreate slots, 100ms poll slices).

    import ray_tpu_torch
    from ray_tpu_torch.dag import InputNode

    with InputNode() as inp:
        x = preproc.step.bind(inp)
        out = trainer.step.bind(x)
    cdag = out.experimental_compile(max_inflight=2)
    for batch in data:
        print(cdag.execute(batch).get())
    cdag.teardown()
"""
from .channel import ChannelClosed, RingReader, RingWriter
from .compiled import CompiledDAG, CompiledDAGRef
from .nodes import ClassMethodNode, InputNode

__all__ = ["InputNode", "ClassMethodNode", "CompiledDAG", "CompiledDAGRef",
           "ChannelClosed", "RingReader", "RingWriter"]
