"""Small bidirectional transformer encoder classifier (PyTorch).

Twin of `skypilot_tpu/models/encoder.py` (BERT-tiny-shaped): token +
position embeddings, pre-norm encoder blocks with non-causal attention
(`ops/attention.mha_reference`, as the JAX model uses the plain
reference and not the kernel), mean-pool and a linear head.  Compute in
`cfg.dtype`, params in `cfg.param_dtype`, cast at use; the head runs in
f32.  Flax's defaults are kept where torch's differ: LayerNorm eps 1e-6
with its statistics in f32 (E[x^2] - E[x]^2, clipped at 0), the tanh
approximation of gelu, and DenseGeneral's kernel layouts (`[D, 3, H,
hd]` for qkv, `[H, hd, D]` for the output), which `models/convert.py`
flattens into torch's [out, in].
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from skypilot_tpu_torch.device import DeviceLike, resolve_device
from skypilot_tpu_torch.models.llama import Dense, _lecun_normal, _param
from skypilot_tpu_torch.ops import attention as attn_lib


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 30522
    dim: int = 128
    n_layers: int = 2
    n_heads: int = 2
    ffn_dim: int = 512
    max_seq_len: int = 512
    num_classes: int = 2
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32


ENCODER_CONFIGS = {
    'bert-tiny': EncoderConfig(),
    'bert-mini': EncoderConfig(dim=256, n_layers=4, n_heads=4, ffn_dim=1024),
    'tiny': EncoderConfig(vocab_size=128, dim=32, n_layers=2, n_heads=2,
                          ffn_dim=64, max_seq_len=64),
}


class LayerNorm(nn.Module):
    """Flax LayerNorm: statistics in f32, eps 1e-6, output in `dtype`."""

    def __init__(self, dim: int, dtype, param_dtype,
                 eps: float = 1e-6) -> None:
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.scale = _param((dim,), param_dtype)
        self.bias = _param((dim,), param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = torch.clamp_min((x32 * x32).mean(-1, keepdim=True) -
                              mean * mean, 0.0)
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.scale.float())
        return (y + self.bias.float()).to(self.dtype)


class EncoderBlock(nn.Module):

    def __init__(self, cfg: EncoderConfig) -> None:
        super().__init__()
        self.cfg = cfg
        dt, pdt = cfg.dtype, cfg.param_dtype
        self.attn_norm = LayerNorm(cfg.dim, dt, pdt)
        self.qkv = Dense(cfg.dim, 3 * cfg.dim, dt, pdt, bias=True)
        self.out = Dense(cfg.dim, cfg.dim, dt, pdt, bias=True)
        self.mlp_norm = LayerNorm(cfg.dim, dt, pdt)
        self.fc1 = Dense(cfg.dim, cfg.ffn_dim, dt, pdt, bias=True)
        self.fc2 = Dense(cfg.ffn_dim, cfg.dim, dt, pdt, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.dim // cfg.n_heads
        qkv = self.qkv(self.attn_norm(x)).view(b, s, 3, cfg.n_heads, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        attn = attn_lib.mha_reference(q, k, v, causal=False)
        x = x + self.out(attn.transpose(1, 2).reshape(b, s, cfg.dim))
        h = F.gelu(self.fc1(self.mlp_norm(x)), approximate='tanh')
        return x + self.fc2(h)


class EncoderClassifier(nn.Module):
    """tokens [B, S] -> f32 logits [B, num_classes], over a given
    parameter dict (`init_params` or `models/convert.py`)."""

    def __init__(self, cfg: EncoderConfig,
                 params: Mapping[str, torch.Tensor]) -> None:
        super().__init__()
        self.cfg = cfg
        self.tok_embed = nn.Embedding(cfg.vocab_size, cfg.dim, device='meta',
                                      dtype=cfg.param_dtype)
        self.pos_embed = nn.Embedding(cfg.max_seq_len, cfg.dim,
                                      device='meta', dtype=cfg.param_dtype)
        self.blocks = nn.ModuleList(EncoderBlock(cfg)
                                    for _ in range(cfg.n_layers))
        self.final_norm = LayerNorm(cfg.dim, cfg.dtype, cfg.param_dtype)
        self.head = Dense(cfg.dim, cfg.num_classes, torch.float32,
                          cfg.param_dtype, bias=True)
        self.load_state_dict(params, strict=True, assign=True)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x = (self.tok_embed.weight.to(dt)[tokens] +
             self.pos_embed.weight.to(dt)[pos][None])
        for block in self.blocks:
            x = block(x)
        pooled = self.final_norm(x).float().mean(dim=1).to(dt)
        return self.head(pooled)


def init_params(cfg: EncoderConfig, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
    """Random weights for `EncoderClassifier(cfg, params)` on `device`
    (default: the GPU; raises without one), drawn as flax initializes
    them: embeddings normal with std 1/sqrt(dim), kernels lecun_normal
    (over the flattened fan-in), biases 0, norms' scale 1."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    pdt = cfg.param_dtype
    params: Dict[str, torch.Tensor] = {}

    def embed(name, n):
        w = torch.empty((n, cfg.dim), dtype=torch.float32, device=device)
        params[name] = w.normal_(0.0, cfg.dim ** -0.5,
                                 generator=generator).to(pdt)

    def linear(name, n_in, n_out):
        params[name + '.weight'] = _lecun_normal((n_out, n_in), n_in, pdt,
                                                 device, generator)
        params[name + '.bias'] = torch.zeros(n_out, dtype=pdt, device=device)

    def norm(name):
        params[name + '.scale'] = torch.ones(cfg.dim, dtype=pdt,
                                             device=device)
        params[name + '.bias'] = torch.zeros(cfg.dim, dtype=pdt,
                                             device=device)

    embed('tok_embed.weight', cfg.vocab_size)
    embed('pos_embed.weight', cfg.max_seq_len)
    for i in range(cfg.n_layers):
        p = f'blocks.{i}.'
        norm(p + 'attn_norm')
        linear(p + 'qkv', cfg.dim, 3 * cfg.dim)
        linear(p + 'out', cfg.dim, cfg.dim)
        norm(p + 'mlp_norm')
        linear(p + 'fc1', cfg.dim, cfg.ffn_dim)
        linear(p + 'fc2', cfg.ffn_dim, cfg.dim)
    norm('final_norm')
    linear('head', cfg.dim, cfg.num_classes)
    return params
