"""ray_tpu_torch.dag — the compiled-DAG channel layer (counterpart of
``ray_tpu.dag``). Only ``channel.slot_oid`` is ported so far: the
adapter registry derives its version ids with it. The sealed ring
channels themselves need the runtime's object store and come with it.
"""
