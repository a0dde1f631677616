"""ray_tpu_torch.data.streaming — the streaming physical executor.

Operators become long-lived stage actors (one ``run_loop`` call for the
whole pipeline) connected by sealed-ring shm channels with credit-based
backpressure: ~zero control dispatches per block in steady state,
bounded memory under skew, plan-order delivery bit-identical to the
task executor. Sits behind the existing ``Dataset`` API via
``DataContext.streaming_executor`` ("auto" by default); exchanges the
pipeline can't stream (shuffle/sort/groupby/...) fall back to the task
executor at a clean plan-split boundary.
"""
from .executor import (ChannelShardFeed, PipelineFeed, StreamingPipeline,
                       compile_plan)
from .telemetry import metrics_summary

__all__ = ["ChannelShardFeed", "PipelineFeed", "StreamingPipeline",
           "compile_plan", "metrics_summary"]
