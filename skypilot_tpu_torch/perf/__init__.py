"""Device-level performance observability of the port (PyTorch).

Twin of `skypilot_tpu/perf/` without its regression gate:

- `cost_model`: a STATIC per-dispatch cost model (FLOPs + HBM bytes
  from the model config, batch occupancy and the page pool's dtype),
  evaluated host-side on the engine loop thread: zero added device
  syncs, enforced by tests.
- `compile_telemetry`: the builds the port makes before a program can
  run (the kernel library's nvcc build, each decode/verify CUDA graph
  capture) feeding skytpu_engine_xla_compile_{total,seconds}, plus the
  runtime recompile sentinel (`perf.recompile`, and
  SKYTPU_STRICT_RECOMPILE=1 as a hard failure in the building call).
- `profiler`: on-demand torch.profiler capture behind /debug/profile
  with bounded on-disk retention.
"""
from skypilot_tpu_torch.perf import compile_telemetry
from skypilot_tpu_torch.perf import cost_model
from skypilot_tpu_torch.perf import profiler

__all__ = ['compile_telemetry', 'cost_model', 'profiler']
