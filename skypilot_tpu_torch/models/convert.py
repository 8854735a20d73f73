"""Carry Flax Llama weights across to `models/llama.py`'s state dict.

`params_from_jax(tree)` takes the Flax `params` collection as a nested
dict of numpy arrays (unboxed; `bfloat16` arrays of the ml_dtypes kind
are accepted) and returns the dict `Llama(cfg, params)` loads:

    embed/embedding [V, D]                 -> embed.weight [V, D]
    layer_i/attn/{q,k,v}_proj/kernel [D,H,hd] -> layers.i.attn.*.weight [H*hd, D]
    layer_i/attn/o_proj/kernel [H, hd, D]  -> layers.i.attn.o_proj.weight [D, H*hd]
    layer_i/{attn,mlp}_norm/scale [D]      -> layers.i.{attn,mlp}_norm.scale
    layer_i/mlp/{gate,up,down}_proj/kernel [in, out] -> ...weight [out, in]
    final_norm/scale [D]                   -> final_norm.scale
    lm_head/kernel [D, V] (untied only)    -> lm_head.weight [V, D]

No q/k permutation: the JAX RoPE rotates split halves, and so does the
port, so head layouts carry over unchanged.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch


def _tensor(arr: Any) -> torch.Tensor:
    # A private, writable copy: JAX hands out read-only host buffers.
    arr = np.array(arr, copy=True, order='C')
    if arr.dtype.name == 'bfloat16':
        # numpy has no native bfloat16: widen exactly, narrow in torch.
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(arr)


def _linear(kernel: Any) -> torch.Tensor:
    """Flax kernel [in..., out...] with one input and one output axis
    group -> torch weight [out, in]."""
    return _tensor(kernel).t().contiguous()


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {
        'embed.weight': _tensor(tree['embed']['embedding']),
        'final_norm.scale': _tensor(tree['final_norm']['scale']),
    }
    if 'lm_head' in tree:
        out['lm_head.weight'] = _linear(tree['lm_head']['kernel'])
    layers = sorted((int(m.group(1)), name) for name in tree
                    if (m := re.fullmatch(r'layer_(\d+)', name)))
    if [i for i, _ in layers] != list(range(len(layers))):
        raise ValueError(f'layer indices are not 0..n-1: {layers}')
    for i, name in layers:
        layer = tree[name]
        attn, mlp = layer['attn'], layer['mlp']
        p = f'layers.{i}.'
        for proj in ('q_proj', 'k_proj', 'v_proj'):
            kernel = np.asarray(attn[proj]['kernel'])        # [D, H, hd]
            out[p + f'attn.{proj}.weight'] = _linear(
                kernel.reshape(kernel.shape[0], -1))
        o_kernel = np.asarray(attn['o_proj']['kernel'])      # [H, hd, D]
        out[p + 'attn.o_proj.weight'] = _linear(
            o_kernel.reshape(-1, o_kernel.shape[-1]))
        out[p + 'attn_norm.scale'] = _tensor(layer['attn_norm']['scale'])
        out[p + 'mlp_norm.scale'] = _tensor(layer['mlp_norm']['scale'])
        for proj in ('gate_proj', 'up_proj', 'down_proj'):
            out[p + f'mlp.{proj}.weight'] = _linear(mlp[proj]['kernel'])
    return out
