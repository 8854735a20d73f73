"""Placement validation before any GPU is rented (PyTorch).

Twin of `skypilot_tpu/parallel/validate.py`, analytic tier: the sharded
parameter + optimizer-state + gradient bytes of a train step on a
planned mesh, plus a transformer activation estimate, against one
device's memory -- catches clearly-OOM plans (a 70B on one 8-GPU node)
without touching a device.

- State: every parameter of `Llama(cfg)` as a meta tensor
  (`models/llama.py::param_shapes`, no allocation), placed by the port's
  own layout (`parallel/sharding.py::param_spec`: a dim the mesh does not
  divide stays whole) and counted at its largest shard, as the JAX
  `_sharded_bytes` does; the optimizer is the port's AdamW (two f32
  moments and an f32 step per parameter).
- Activations: the JAX module's estimate, term for term.
- Device facts are the card's, not a TPU's: `DEVICES` holds each GPU
  kind's memory as `torch.cuda.mem_get_info()` reports it on the card
  and the share a program can use, measured there (chip_smoke.py's
  `validate` phase prints both and checks this table against them).
- Accelerator strings take the GPU form `H100:<n>` (n GPUs that one
  plan shards over, as a TPU slice's chips: 'H100:128' is 16 nodes of 8)
  or `H100:<n>x<nodes>`: the node count stands where the TPU form has
  slices, and more than one gives the plan a `dcn` axis (data
  parallelism across them, every other axis within each).

The compiled tier (`compile=True`) lowers the step for an abstract PJRT
TPU topology; PyTorch has no counterpart, so it is refused.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional

from skypilot_tpu_torch import exceptions


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    hbm_bytes: int            # torch.cuda.mem_get_info()'s total
    usable_fraction: float    # what a training process can allocate


# NVIDIA H100 80GB HBM3, power limit 700.00 W (chip_smoke.py's hbm probe,
# checked in its graft_entry phase): the total mem_get_info reports, and
# the free share of it (0.98539) once a process holds its CUDA context,
# the caching allocator and a one-rank NCCL group, rounded down.
DEVICES: Dict[str, DeviceSpec] = {
    'h100': DeviceSpec(hbm_bytes=85_017_493_504, usable_fraction=0.985),
}

_ACCELERATOR = re.compile(r'(?P<kind>[A-Za-z0-9]+):(?P<gpus>\d+)'
                          r'(?:x(?P<nodes>\d+))?')


def parse_accelerator(accelerator: str):
    """'H100:8' -> ('h100', 8, 1); 'H100:8x4' -> ('h100', 8, 4 nodes)."""
    m = _ACCELERATOR.fullmatch(accelerator.strip())
    if m is None or m.group('kind').lower() not in DEVICES:
        raise exceptions.InvalidRequestError(
            f'accelerator {accelerator!r}: expected <kind>:<gpus>'
            f'[x<nodes>] with kind in {sorted(DEVICES)}')
    gpus, nodes = int(m.group('gpus')), int(m.group('nodes') or 1)
    if gpus < 1 or nodes < 1:
        raise exceptions.InvalidRequestError(
            f'accelerator {accelerator!r}: counts must be positive')
    return m.group('kind').lower(), gpus, nodes


@dataclasses.dataclass
class PlacementReport:
    accelerator: str
    mesh_plan: 'object'                    # parallel.mesh.MeshPlan
    per_device_bytes: int                  # peak per-device memory estimate
    hbm_bytes_per_device: int
    fits: bool
    mode: str                              # 'analytic'
    breakdown: Dict[str, int]
    warnings: List[str]
    usable_fraction: float                 # of hbm_bytes_per_device

    @property
    def utilization(self) -> float:
        usable = self.hbm_bytes_per_device * self.usable_fraction
        return self.per_device_bytes / max(usable, 1)

    def summary(self) -> str:
        gb = 1024 ** 3
        lines = [
            f'placement: {self.accelerator}  plan={self.mesh_plan}',
            f'per-device HBM: {self.per_device_bytes / gb:.2f} GiB of '
            f'{self.hbm_bytes_per_device / gb:.2f} GiB '
            f'({self.utilization:.0%} of usable)  [{self.mode}]',
        ]
        for k, v in sorted(self.breakdown.items()):
            lines.append(f'  {k}: {v / gb:.2f} GiB')
        for w in self.warnings:
            lines.append(f'  WARNING: {w}')
        lines.append('FITS' if self.fits else 'DOES NOT FIT')
        return '\n'.join(lines)


def _largest_shard_bytes(cfg, plan) -> int:
    """Bytes of the largest per-device shard of every parameter of
    `Llama(cfg)` on `plan`'s mesh, from meta tensors."""
    import torch
    from skypilot_tpu_torch.models.llama import param_shapes
    from skypilot_tpu_torch.parallel import sharding
    from skypilot_tpu_torch.parallel.mesh import MESH_AXES
    mesh_shape = {a: getattr(plan, a) for a in MESH_AXES}
    total = 0
    for name, shape in param_shapes(cfg).items():
        t = torch.empty(shape, dtype=cfg.param_dtype, device='meta')
        spec = sharding.param_spec(name, shape, mesh_shape)
        total += (t.numel() // sharding.shard_factor(spec, mesh_shape) *
                  t.element_size())
    return total


def validate_placement(accelerator: str,
                       model_name: str = 'llama3-8b',
                       batch: int = 8,
                       seq: int = 2048,
                       data: Optional[int] = None,
                       fsdp: Optional[int] = None,
                       tensor: Optional[int] = None,
                       compile: bool = False,  # pylint: disable=redefined-builtin
                       remat: bool = True) -> PlacementReport:
    """Validate that a train-step placement fits the target GPUs' memory
    (analytic: sharded param/optimizer/gradient bytes + a transformer
    activation estimate).  Touches no device."""
    from skypilot_tpu_torch.models.llama import LLAMA_CONFIGS, param_shapes
    from skypilot_tpu_torch.parallel.mesh import plan_mesh
    if compile:
        raise ValueError(
            'compile=True lowers the step for an abstract PJRT TPU topology '
            '(the JAX package\'s compiled tier); PyTorch has no counterpart: '
            'validate analytically, or run a step on the card')
    kind, gpus, nodes = parse_accelerator(accelerator)
    device = DEVICES[kind]
    n_devices = gpus * nodes
    if model_name not in LLAMA_CONFIGS:
        raise exceptions.InvalidRequestError(
            f'unknown model {model_name!r}; known: '
            f'{sorted(LLAMA_CONFIGS)}')
    cfg = LLAMA_CONFIGS[model_name]
    plan = plan_mesh(n_devices, data=data, fsdp=fsdp, tensor=tensor,
                     dcn=nodes if nodes > 1 else None)

    breakdown: Dict[str, int] = {}
    params_bytes = _largest_shard_bytes(cfg, plan)
    # params + AdamW's exp_avg and exp_avg_sq (f32, the params' shards)
    # + one f32 step per parameter tensor.
    state_bytes = 3 * params_bytes + 4 * len(param_shapes(cfg))
    breakdown['params+optimizer_state'] = state_bytes
    # Gradients are live alongside params during the optimizer step.
    breakdown['gradients'] = params_bytes

    # Activation estimate (with remat: ~one layer's activations + the
    # per-layer residual stream checkpoints; without: all layers).
    batch_per_dev = batch / max(
        plan.dcn * plan.data * plan.fsdp * plan.expert, 1)
    hidden_bytes = batch_per_dev * seq * cfg.dim * 2      # bf16
    ffn_mult = (cfg.ffn_dim / cfg.dim if getattr(cfg, 'ffn_dim', None)
                else 3.5)
    per_layer = hidden_bytes * (4 + 2 * ffn_mult) / max(plan.tensor, 1)
    layers_live = 2 if remat else cfg.n_layers
    act_bytes = int(hidden_bytes * cfg.n_layers        # residual ckpts
                    + per_layer * layers_live
                    + batch_per_dev * seq * cfg.vocab_size * 4
                    / max(plan.tensor, 1))             # logits f32
    breakdown['activations_est'] = act_bytes

    per_device = state_bytes + params_bytes + act_bytes
    fits = per_device <= device.hbm_bytes * device.usable_fraction
    return PlacementReport(accelerator=accelerator, mesh_plan=plan,
                           per_device_bytes=per_device,
                           hbm_bytes_per_device=device.hbm_bytes, fits=fits,
                           mode='analytic', breakdown=breakdown, warnings=[],
                           usable_fraction=device.usable_fraction)
