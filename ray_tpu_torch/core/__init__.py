"""ray_tpu_torch.core — the runtime-side pieces the port's serving layer
reads: the typed config flags (``config``) and the per-process flight
recorder (``flight``). Counterpart of the matching modules of
``ray_tpu.core``; the task/actor runtime itself is not ported yet.
"""
