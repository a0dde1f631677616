"""ray_tpu_torch.util — metrics (``metrics``), trace-context propagation
(``tracing``), step profiling (``profiling``), placement groups
(``placement_group``) and scheduling strategies
(``scheduling_strategies``): the port's copies of the matching
``ray_tpu.util`` modules.
"""
