"""Known-bad: metric families that break the registry's conventions
(metric-naming), against the port's copy of the registry."""
from skypilot_tpu_torch.server import metrics as metrics_lib


def record():
    metrics_lib.inc_counter('skytpu_port_rogue_events')      # BAD: no _total
    metrics_lib.set_gauge('skytpu_port_rogue_total', 1.0)     # BAD: _total gauge
    metrics_lib.observe_hist('skytpu_port_rogue_millis', 1.0)  # BAD: unit
