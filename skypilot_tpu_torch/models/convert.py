"""Carry Flax weights across to the port's state dicts: Llama (with its
experts) here, the encoder and ResNet at the end of the file.

`params_from_jax(tree)` takes the Flax `params` collection as a nested
dict of numpy arrays (unboxed; `bfloat16` arrays of the ml_dtypes kind
are accepted) and returns the dict `Llama(cfg, params)` loads:

    embed/embedding [V, D]                 -> embed.weight [V, D]
    layer_i/attn/{q,k,v}_proj/kernel [D,H,hd] -> layers.i.attn.*.weight [H*hd, D]
    layer_i/attn/o_proj/kernel [H, hd, D]  -> layers.i.attn.o_proj.weight [D, H*hd]
    layer_i/{attn,mlp}_norm/scale [D]      -> layers.i.{attn,mlp}_norm.scale
    layer_i/mlp/{gate,up,down}_proj/kernel [in, out] -> ...weight [out, in]
    layer_i/moe_mlp/router/kernel [D, E]   -> layers.i.moe_mlp.router.weight [E, D]
    layer_i/moe_mlp/{w_gate,w_up} [E, D, F] -> layers.i.moe_mlp.{w_gate,w_up} (as is)
    layer_i/moe_mlp/w_down [E, F, D]       -> layers.i.moe_mlp.w_down (as is)
    final_norm/scale [D]                   -> final_norm.scale
    lm_head/kernel [D, V] (untied only)    -> lm_head.weight [V, D]

No q/k permutation: the JAX RoPE rotates split halves, and so does the
port, so head layouts carry over unchanged.

`shard_params(full, mesh)` carries a whole state dict (this function's
output, or the port's own `init_params`) onto a tensor-parallel rank:
its slices, as `Llama(cfg, params, mesh)` loads them.
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


def moe_params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A Flax `MoEMLP`'s params -> `models/moe.py` MoEMLP's state dict:
    the router kernel transposed, the expert weights as they are."""
    out = {'router.weight': _linear(tree['router']['kernel'])}
    for name in ('w_gate', 'w_up', 'w_down'):
        out[name] = _tensor(tree[name])
    return out


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
        attn = layer['attn']
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
        if 'moe_mlp' in layer:
            for name, t in moe_params_from_jax(layer['moe_mlp']).items():
                out[p + 'moe_mlp.' + name] = t
        else:
            for proj in ('gate_proj', 'up_proj', 'down_proj'):
                out[p + f'mlp.{proj}.weight'] = _linear(
                    layer['mlp'][proj]['kernel'])
    return out


def shard_params(full: Mapping[str, torch.Tensor],
                 mesh) -> Dict[str, torch.Tensor]:
    """This rank's slices of a whole Llama state dict on `mesh`
    (`parallel/sharding.py` PARAM_AXES through the rules), copied onto the
    mesh's device; `full` is only read."""
    from skypilot_tpu_torch.parallel import sharding
    out = {}
    for name, t in full.items():
        spec = sharding.param_spec(name, t.shape, mesh.shape)
        out[name] = sharding.local_slice(t, spec, mesh).to(
            mesh.device, copy=True).contiguous()
    return out


def encoder_params_from_jax(tree: Mapping[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """A Flax `EncoderClassifier`'s params -> `models/encoder.py`'s state
    dict:

        Embed_0/embedding, Embed_1/embedding -> tok_embed, pos_embed .weight
        EncoderBlock_i/LayerNorm_{0,1}/{scale,bias} -> blocks.i.{attn,mlp}_norm
        EncoderBlock_i/DenseGeneral_0 kernel [D,3,H,hd], bias [3,H,hd]
                                             -> blocks.i.qkv [3*H*hd, D], [3*H*hd]
        EncoderBlock_i/DenseGeneral_1 kernel [H,hd,D], bias [D]
                                             -> blocks.i.out [D, H*hd], [D]
        EncoderBlock_i/Dense_{0,1}           -> blocks.i.fc{1,2}
        LayerNorm_0, Dense_0                 -> final_norm, head
    """
    def dense(node, n_in_axes=1):
        kernel = np.asarray(node['kernel'])
        n_in = int(np.prod(kernel.shape[:n_in_axes]))
        return {'weight': _linear(kernel.reshape(n_in, -1)),
                'bias': _tensor(np.asarray(node['bias']).reshape(-1))}

    out: Dict[str, torch.Tensor] = {
        'tok_embed.weight': _tensor(tree['Embed_0']['embedding']),
        'pos_embed.weight': _tensor(tree['Embed_1']['embedding']),
    }
    modules = {'final_norm': tree['LayerNorm_0'],
               'head': dense(tree['Dense_0'])}
    blocks = sorted(int(m.group(1)) for name in tree
                    if (m := re.fullmatch(r'EncoderBlock_(\d+)', name)))
    for i in blocks:
        block = tree[f'EncoderBlock_{i}']
        p = f'blocks.{i}.'
        modules.update({
            p + 'attn_norm': block['LayerNorm_0'],
            p + 'qkv': dense(block['DenseGeneral_0']),
            p + 'out': dense(block['DenseGeneral_1'], n_in_axes=2),
            p + 'mlp_norm': block['LayerNorm_1'],
            p + 'fc1': dense(block['Dense_0']),
            p + 'fc2': dense(block['Dense_1']),
        })
    for name, leaves in modules.items():
        for key, value in leaves.items():
            out[f'{name}.{key}'] = (value if isinstance(value, torch.Tensor)
                                    else _tensor(value))
    return out


def resnet_state_from_jax(params: Mapping[str, Any],
                          batch_stats: Mapping[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """A Flax `ResNet`'s params and batch_stats -> `models/resnet.py`'s
    state dict:

        Conv_0/kernel [7,7,3,W]            -> stem_conv.weight [W,3,7,7]
        BatchNorm_0/{scale,bias}, {mean,var} -> stem_bn.{scale,bias,mean,var}
        BottleneckBlock_i/Conv_{0,1,2,3}   -> blocks.i.{conv1,conv2,conv3,proj_conv}
        BottleneckBlock_i/BatchNorm_{0..3} -> blocks.i.{bn1,bn2,bn3,proj_bn}
        Dense_0/{kernel [C,K], bias}       -> head.{weight [K,C], bias}

    Conv kernels go from [kh, kw, in, out] to [out, in, kh, kw].
    """
    out: Dict[str, torch.Tensor] = {}

    def conv(name, node):
        out[name + '.weight'] = _tensor(
            np.asarray(node['kernel']).transpose(3, 2, 0, 1))

    def bn(name, node, stats):
        for key in ('scale', 'bias'):
            out[f'{name}.{key}'] = _tensor(node[key])
        for key in ('mean', 'var'):
            out[f'{name}.{key}'] = _tensor(stats[key])

    conv('stem_conv', params['Conv_0'])
    bn('stem_bn', params['BatchNorm_0'], batch_stats['BatchNorm_0'])
    blocks = sorted(int(m.group(1)) for name in params
                    if (m := re.fullmatch(r'BottleneckBlock_(\d+)', name)))
    for i in blocks:
        node, stats = (params[f'BottleneckBlock_{i}'],
                       batch_stats[f'BottleneckBlock_{i}'])
        p = f'blocks.{i}.'
        names = ('conv1', 'conv2', 'conv3', 'proj_conv')
        norms = ('bn1', 'bn2', 'bn3', 'proj_bn')
        for j in range(4 if 'Conv_3' in node else 3):
            conv(p + names[j], node[f'Conv_{j}'])
            bn(p + norms[j], node[f'BatchNorm_{j}'], stats[f'BatchNorm_{j}'])
    out['head.weight'] = _linear(params['Dense_0']['kernel'])
    out['head.bias'] = _tensor(params['Dense_0']['bias'])
    return out
