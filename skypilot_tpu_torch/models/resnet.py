"""ResNet (bottleneck blocks), the vision model of the zoo (PyTorch).

Twin of `skypilot_tpu/models/resnet.py`: the input is NHWC, as in JAX;
inside, activations are NCHW views of NHWC memory (channels-last), so
the convolutions (cuDNN through `F.conv2d`, as XLA computes them outside
any Pallas kernel) take the layout the input already has.  Compute in
`cfg.dtype`, params and running statistics in `cfg.param_dtype`; the
head runs in f32.  Where flax differs from torch, flax is kept:

- `padding='SAME'` is asymmetric at stride 2 (the 7x7/2 stem pads 2
  before and 3 after an even size, the 3x3/2 conv 0 and 1): explicit
  `F.pad` by `same_padding`, never `padding=k // 2`;
- the 3x3/2 max pool pads with -inf;
- BatchNorm: statistics over N, H, W in f32 (E[x^2] - E[x]^2, clipped at
  0), eps 1e-5, running averages updated as 0.9 * old + 0.1 * batch
  with the BIASED batch variance (torch's momentum 0.1, but
  `nn.BatchNorm2d` would store the unbiased one); `train=False`
  normalizes by the running averages.

`forward(x, train=True)` updates the running averages in place, the
counterpart of applying the Flax model with `batch_stats` mutable.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from skypilot_tpu_torch.device import DeviceLike, resolve_device
from skypilot_tpu_torch.models.llama import Dense, _lecun_normal, _param

BN_MOMENTUM, BN_EPS = 0.9, 1e-5


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)   # ResNet-50
    num_classes: int = 1000
    width: int = 64
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32


RESNET_CONFIGS = {
    'resnet18': ResNetConfig(stage_sizes=(2, 2, 2, 2)),
    'resnet50': ResNetConfig(),
    'tiny': ResNetConfig(stage_sizes=(1, 1), num_classes=10, width=8),
}


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's 'SAME' padding of one spatial dim: (before, after), the odd
    element after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel: int, stride: int,
              value: float = 0.0) -> torch.Tensor:
    """Pad NCHW `x` for a SAME window of `kernel` at `stride`."""
    top, bottom = same_padding(x.shape[2], kernel, stride)
    left, right = same_padding(x.shape[3], kernel, stride)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


class Conv(nn.Module):
    """Bias-free conv with SAME padding; weight [out, in, k, k] (Flax
    kernel [k, k, in, out] permuted)."""

    def __init__(self, n_in: int, n_out: int, kernel: int, stride: int,
                 dtype, param_dtype) -> None:
        super().__init__()
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.weight = _param((n_out, n_in, kernel, kernel), param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _pad_same(x.to(self.dtype), self.kernel, self.stride)
        return F.conv2d(x, self.weight.to(self.dtype), stride=self.stride)


class BatchNorm(nn.Module):
    """Flax BatchNorm over NCHW: scale and bias are parameters, the
    running `mean` and `var` buffers."""

    def __init__(self, features: int, dtype, param_dtype) -> None:
        super().__init__()
        self.dtype = dtype
        self.scale = _param((features,), param_dtype)
        self.bias = _param((features,), param_dtype)
        self.register_buffer('mean', torch.empty(
            features, dtype=param_dtype, device='meta'))
        self.register_buffer('var', torch.empty(
            features, dtype=param_dtype, device='meta'))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x32 = x.float()
        if train:
            mean = x32.mean(dim=(0, 2, 3))
            var = torch.clamp_min((x32 * x32).mean(dim=(0, 2, 3)) -
                                  mean * mean, 0.0)
            with torch.no_grad():
                self.mean.mul_(BN_MOMENTUM).add_(
                    (1 - BN_MOMENTUM) * mean.to(self.mean.dtype))
                self.var.mul_(BN_MOMENTUM).add_(
                    (1 - BN_MOMENTUM) * var.to(self.var.dtype))
        else:
            mean, var = self.mean.float(), self.var.float()
        mul = torch.rsqrt(var + BN_EPS) * self.scale.float()
        y = ((x32 - mean[:, None, None]) * mul[:, None, None] +
             self.bias.float()[:, None, None])
        return y.to(self.dtype)


class BottleneckBlock(nn.Module):

    def __init__(self, n_in: int, features: int, stride: int,
                 cfg: ResNetConfig) -> None:
        super().__init__()
        dt, pdt = cfg.dtype, cfg.param_dtype
        self.conv1 = Conv(n_in, features, 1, 1, dt, pdt)
        self.bn1 = BatchNorm(features, dt, pdt)
        self.conv2 = Conv(features, features, 3, stride, dt, pdt)
        self.bn2 = BatchNorm(features, dt, pdt)
        self.conv3 = Conv(features, features * 4, 1, 1, dt, pdt)
        self.bn3 = BatchNorm(features * 4, dt, pdt)
        # The projection exists where the residual's shape differs, as
        # the Flax block decides from the shapes it sees.
        self.proj = stride != 1 or n_in != features * 4
        if self.proj:
            self.proj_conv = Conv(n_in, features * 4, 1, stride, dt, pdt)
            self.proj_bn = BatchNorm(features * 4, dt, pdt)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), train))
        y = F.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        residual = (self.proj_bn(self.proj_conv(x), train) if self.proj
                    else x)
        return F.relu(y + residual)


def _blocks(cfg: ResNetConfig):
    """(n_in, features, stride) of every bottleneck block, in order."""
    out, n_in = [], cfg.width
    for i, n_blocks in enumerate(cfg.stage_sizes):
        for j in range(n_blocks):
            features = cfg.width * 2**i
            out.append((n_in, features, 2 if i > 0 and j == 0 else 1))
            n_in = features * 4
    return out


class ResNet(nn.Module):
    """images [B, H, W, C] (NHWC) -> f32 logits [B, num_classes], over a
    given state dict (`init_params` or `models/convert.py`): parameters
    and the BatchNorms' running averages."""

    def __init__(self, cfg: ResNetConfig,
                 state: Dict[str, torch.Tensor]) -> None:
        super().__init__()
        self.cfg = cfg
        dt, pdt = cfg.dtype, cfg.param_dtype
        self.stem_conv = Conv(3, cfg.width, 7, 2, dt, pdt)
        self.stem_bn = BatchNorm(cfg.width, dt, pdt)
        self.blocks = nn.ModuleList(BottleneckBlock(*b, cfg)
                                    for b in _blocks(cfg))
        self.head = Dense(_blocks(cfg)[-1][1] * 4, cfg.num_classes,
                          torch.float32, pdt, bias=True)
        self.load_state_dict(state, strict=True, assign=True)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)                  # NCHW view of NHWC
        x = F.relu(self.stem_bn(self.stem_conv(x), train))
        x = F.max_pool2d(_pad_same(x, 3, 2, float('-inf')), 3, 2)
        for block in self.blocks:
            x = block(x, train)
        return self.head(x.float().mean(dim=(2, 3)).to(self.cfg.dtype))


def init_params(cfg: ResNetConfig, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
    """Random state for `ResNet(cfg, state)` on `device` (default: the
    GPU; raises without one), as flax initializes it: conv and head
    kernels lecun_normal (conv fan-in k*k*in), biases 0, BatchNorm scale
    1, bias 0, running mean 0 and variance 1."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    pdt = cfg.param_dtype
    state: Dict[str, torch.Tensor] = {}

    def conv(name, n_in, n_out, k):
        state[name + '.weight'] = _lecun_normal((n_out, n_in, k, k),
                                                n_in * k * k, pdt, device,
                                                generator)

    def bn(name, n):
        for key, fill in (('scale', 1.0), ('bias', 0.0), ('mean', 0.0),
                          ('var', 1.0)):
            state[f'{name}.{key}'] = torch.full((n,), fill, dtype=pdt,
                                                device=device)

    conv('stem_conv', 3, cfg.width, 7)
    bn('stem_bn', cfg.width)
    for i, (n_in, features, stride) in enumerate(_blocks(cfg)):
        p = f'blocks.{i}.'
        conv(p + 'conv1', n_in, features, 1)
        bn(p + 'bn1', features)
        conv(p + 'conv2', features, features, 3)
        bn(p + 'bn2', features)
        conv(p + 'conv3', features, features * 4, 1)
        bn(p + 'bn3', features * 4)
        if stride != 1 or n_in != features * 4:
            conv(p + 'proj_conv', n_in, features * 4, 1)
            bn(p + 'proj_bn', features * 4)
    n_out = _blocks(cfg)[-1][1] * 4
    state['head.weight'] = _lecun_normal((cfg.num_classes, n_out), n_out,
                                         pdt, device, generator)
    state['head.bias'] = torch.zeros(cfg.num_classes, dtype=pdt,
                                     device=device)
    return state
