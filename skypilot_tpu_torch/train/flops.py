"""Model-FLOP accounting for the trainer's MFU gauges and the smoke run.

Copied from `skypilot_tpu/train/flops.py`: `train_flops_per_token`,
`estimate_mfu`, `train_hbm_bytes_per_token` and `train_arith_intensity`
verbatim (pinned by `tests/test_torch_train.py`).  The peak table holds
the card this package runs on, not the TPU chips: the H100 SXM's dense
bf16 tensor-core rate from NVIDIA's data sheet, and the nominal 'cpu'
entry so the accounting runs anywhere.
"""
from __future__ import annotations

from typing import Optional

import torch

PEAK_BF16_TFLOPS = {
    'h100': 989.0,  # H100 SXM, dense bf16 (NVIDIA data sheet)
    'cpu': 1.0,  # nominal, so accounting runs anywhere
}


def chip_kind(device: Optional[torch.device] = None) -> str:
    """Normalized kind of `device` (default: the current CUDA device when
    there is one): a key of PEAK_BF16_TFLOPS, 'cpu' when unrecognized."""
    if device is None:
        if not torch.cuda.is_available():
            return 'cpu'
        device = torch.device('cuda', torch.cuda.current_device())
    if torch.device(device).type != 'cuda':
        return 'cpu'
    kind = torch.cuda.get_device_name(device).lower().replace(' ', '')
    for name in PEAK_BF16_TFLOPS:
        if name in kind:
            return name
    return 'cpu'


def train_flops_per_token(n_params: int, n_layers: int, dim: int,
                          seq_len: int) -> float:
    """fwd+bwd model FLOPs per trained token: 6N dense + causal
    attention term."""
    return 6 * n_params + 6 * n_layers * seq_len * dim

def estimate_mfu(tokens_per_s: float, n_params: int, n_layers: int,
                 dim: int, seq_len: int, n_chips: int = 1,
                 kind: Optional[str] = None) -> float:
    """Achieved model TFLOP/s as % of the slice's peak bf16 TFLOP/s.

    Returns 0.0 on unrecognized hardware rather than a bogus ratio."""
    kind = kind or chip_kind()
    peak = PEAK_BF16_TFLOPS.get(kind)
    if not peak or tokens_per_s <= 0:
        return 0.0
    achieved_tflops = (tokens_per_s *
                       train_flops_per_token(n_params, n_layers, dim,
                                             seq_len) / 1e12)
    return 100.0 * achieved_tflops / (peak * max(1, n_chips))

def train_hbm_bytes_per_token(n_params: int, tokens_per_step: int,
                              param_bytes: int = 2,
                              opt_state_bytes: int = 8) -> float:
    """Modeled HBM traffic per trained token: the trainer twin of the
    decode cost model's bytes/token gauge (perf/cost_model.py).

    One optimizer step streams the weight tree through HBM a fixed
    number of times — forward read + backward read (2x params), the
    gradient write (1x), and the Adam moment read-modify-write (2x the
    f32 m/v pair) — all amortized over the step's token count.
    Activation traffic is recompute-dominated under remat and omitted;
    this is a floor, matching the decode model's roofline role."""
    if tokens_per_step <= 0:
        return 0.0
    step_bytes = n_params * (3 * param_bytes + 2 * opt_state_bytes)
    return step_bytes / tokens_per_step

def train_arith_intensity(n_params: int, n_layers: int, dim: int,
                          seq_len: int, tokens_per_step: int,
                          param_bytes: int = 2,
                          opt_state_bytes: int = 8) -> float:
    """FLOPs per modeled HBM byte for one train step."""
    bytes_per_token = train_hbm_bytes_per_token(
        n_params, tokens_per_step, param_bytes, opt_state_bytes)
    if bytes_per_token <= 0:
        return 0.0
    return train_flops_per_token(n_params, n_layers, dim,
                                 seq_len) / bytes_per_token
