"""ray_tpu_torch.core — the port's single-host runtime: the head
(``runtime``: object directory, scheduler with GPU leases, worker pool,
actors), its worker processes (``worker``), the shared-memory object
store (``object_store`` over ``native/objstore.cc``), the public API
(``api``), the typed config flags (``config``) and the flight recorder
(``flight``). Copies of the matching modules of ``ray_tpu.core``; the
driver client, node agents, the state API and compiled-DAG channels are
not ported yet.
"""
