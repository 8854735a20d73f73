"""Managed jobs: auto-recovering tasks on preemptible TPU slices
(parity: sky/jobs/)."""
from skypilot_tpu_torch.jobs.core import cancel, launch, queue, tail_logs
from skypilot_tpu_torch.jobs.state import ManagedJobStatus

__all__ = ['launch', 'queue', 'cancel', 'tail_logs', 'ManagedJobStatus']
