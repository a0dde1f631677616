"""ray_tpu_torch.util — metrics (``metrics``), trace-context propagation
(``tracing``) and step profiling (``profiling``), the port's copies of
the matching ``ray_tpu.util`` modules.
"""
