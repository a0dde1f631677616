"""ray_tpu_torch.core — the port's runtime: the head (``runtime``:
object directory, scheduler with GPU leases, worker pool, actors), its
worker processes (``worker``), the shared-memory object store
(``object_store`` over ``native/objstore.cc``), node agents that join
other hosts (``node_agent``), the object transfer between node stores
(``object_transfer``), driver clients that attach to a running head
(``client``), the public API (``api``), the typed config flags
(``config``) and the flight recorder (``flight``). Copies of the
matching modules of ``ray_tpu.core``. The state API is
``ray_tpu_torch.state`` and the compiled-DAG channels are
``ray_tpu_torch.dag``.
"""
