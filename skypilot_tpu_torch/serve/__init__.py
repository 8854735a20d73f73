"""Serve: replicated, autoscaled, load-balanced services on TPU clusters
(capability parity: sky/serve/ — replica_managers.py:731, autoscalers.py:455,
load_balancer.py:24, spot_placer.py:170, service_spec.py).
"""
from skypilot_tpu_torch.serve.core import down
from skypilot_tpu_torch.serve.core import status
from skypilot_tpu_torch.serve.core import tail_replica_logs
from skypilot_tpu_torch.serve.core import up
from skypilot_tpu_torch.serve.core import update
from skypilot_tpu_torch.serve.service_spec import ServiceSpec

__all__ = ['up', 'down', 'status', 'tail_replica_logs', 'update',
           'ServiceSpec']
