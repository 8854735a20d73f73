"""skypilot_tpu_torch: the PyTorch/CUDA port of skypilot_tpu/.

A second package beside the JAX one, mirroring its module layout: the
Llama decoder (`models/`), attention with a hand-written Hopper
flash-forward kernel (`ops/`, `csrc/`), the continuous-batching decode
engine and its HTTP server (`inference/`), the perf plane (`perf/`:
cost model, build telemetry and recompile sentinel, profiler),
parallelism (`parallel/`: tensor, data/FSDP, context, pipeline and
expert axes, placement validation), the graft entry's twin
(`graft_entry`), and
verbatim copies of the JAX-free modules they need (`sky_logging`,
`utils/timeline`, `server/metrics`, `server/tracing`).  It imports torch, never jax, and
nothing of `skypilot_tpu`.  Entry points run on CUDA unless the caller
passes device='cpu'.
"""

__version__ = '0.1.0'
