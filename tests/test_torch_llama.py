"""Port Llama against the Flax model on the same weights: the converter,
full-forward logits (`tiny` and a narrow 2-layer llama2-7b-shaped config),
the serving cache path (prefill, decode steps, a chunk past the cache
end), and greedy tokens in bf16."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from skypilot_tpu.models import llama as jl
from skypilot_tpu_torch.models import llama as tl
from skypilot_tpu_torch.models.convert import params_from_jax

torch.set_num_threads(1)

# llama2-7b's shape at narrow width: MHA, head_dim 128, untied lm_head,
# rope_theta 1e4; 2 layers.
NARROW = dict(vocab_size=512, dim=256, n_layers=2, n_heads=2, n_kv_heads=2,
              ffn_dim=688, rope_theta=10000.0, max_seq_len=64, remat=False)
# f32 compute on both sides: differences are summation order only.
F32_ATOL = 1e-4


def _configs(name, dtype_j=jnp.float32, dtype_t=torch.float32, **kw):
    if name == 'narrow-llama2':
        base_j = jl.LlamaConfig(**NARROW)
        base_t = tl.LlamaConfig(**NARROW)
    else:
        base_j, base_t = jl.LLAMA_CONFIGS[name], tl.LLAMA_CONFIGS[name]
    return (dataclasses.replace(base_j, dtype=dtype_j, **kw),
            dataclasses.replace(base_t, dtype=dtype_t, **kw))


class _Jitted:
    """A Flax model with a jitted apply (eager Flax dispatches op by op)."""

    def __init__(self, model):
        self.model = model
        self.apply = jax.jit(model.apply,
                             static_argnames=('decode', 'mutable'))


@functools.lru_cache(maxsize=None)
def _models(cfg_j, cfg_t, seed=0):
    model_j = jl.Llama(cfg_j)
    params_j = meta.unbox(jax.jit(model_j.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))['params'])
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j))
    return _Jitted(model_j), params_j, tl.Llama(cfg_t, params_t)


def _tokens(shape, vocab, seed=1):
    return np.random.default_rng(seed).integers(
        0, vocab, shape).astype(np.int32)


def test_convert_layouts():
    cfg_j, cfg_t = _configs('narrow-llama2')
    _, params_j, model_t = _models(cfg_j, cfg_t)
    sd = model_t.state_dict()
    assert 'lm_head.weight' in sd and len(sd) == 3 + 9 * cfg_t.n_layers
    kq = np.asarray(params_j['layer_1']['attn']['q_proj']['kernel'])
    ko = np.asarray(params_j['layer_1']['attn']['o_proj']['kernel'])
    x = np.random.default_rng(0).standard_normal((3, cfg_t.dim), np.float32)
    h = np.einsum('bd,dhk->bhk', x, kq)
    with torch.no_grad():
        q = model_t.layers[1].attn.q_proj(torch.from_numpy(x)).numpy()
        o = model_t.layers[1].attn.o_proj(torch.from_numpy(
            h.reshape(3, -1))).numpy()
    np.testing.assert_allclose(q, h.reshape(3, -1), atol=1e-5)
    np.testing.assert_allclose(o, np.einsum('bhk,hkd->bd', h, ko), atol=1e-4)
    # Tied configs carry no lm_head.
    tied_j = dataclasses.replace(cfg_j, tie_embeddings=True)
    p = meta.unbox(jax.jit(jl.Llama(tied_j).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))['params'])
    assert 'lm_head.weight' not in params_from_jax(
        jax.tree.map(np.asarray, p))


@pytest.mark.parametrize('name,impl', [('tiny', 'flash'), ('tiny', 'xla'),
                                       ('narrow-llama2', 'flash')])
def test_logits_match_flax(name, impl):
    cfg_j, cfg_t = _configs(name, attention_impl=impl)
    model_j, params_j, model_t = _models(cfg_j, cfg_t)
    toks = _tokens((2, 32), cfg_t.vocab_size)
    want = np.asarray(model_j.apply({'params': params_j}, toks))
    with torch.no_grad():
        got = model_t(torch.from_numpy(toks)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


def test_tied_embeddings_match_flax():
    cfg_j, cfg_t = _configs('tiny', tie_embeddings=True)
    model_j, params_j, model_t = _models(cfg_j, cfg_t)
    toks = _tokens((1, 16), cfg_t.vocab_size)
    with torch.no_grad():
        got = model_t(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(model_j.apply({'params': params_j}, toks)),
        atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize('name', ['tiny', 'narrow-llama2'])
def test_decode_cache_path_matches_flax(name):
    """Fresh prefill, 3 decode steps at per-row positions, then a chunk
    whose tail runs past the cache end (those writes must drop)."""
    cfg_j, cfg_t = _configs(name)
    model_j, params_j, model_t = _models(cfg_j, cfg_t)
    max_len = cfg_t.max_seq_len
    toks = _tokens((2, 16), cfg_t.vocab_size)
    logits_j, cache = model_j.apply({'params': params_j}, toks,
                                    decode=True, mutable=('cache',))
    with torch.no_grad():
        logits_t, cache_t = model_t(torch.from_numpy(toks), decode=True)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               atol=F32_ATOL, rtol=0)
    pos = np.array([[16], [12]], np.int32)       # rows at their own lengths
    step = toks[:, -1:]
    for _ in range(3):
        logits_j, cache = model_j.apply(
            {'params': params_j, 'cache': cache['cache']}, step,
            positions=pos, decode=True, mutable=('cache',))
        with torch.no_grad():
            logits_t, cache_t = model_t(
                torch.from_numpy(step), torch.from_numpy(pos), decode=True,
                cache=cache_t)
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                                   atol=F32_ATOL, rtol=0)
        step = np.asarray(jnp.argmax(logits_j, -1)).astype(np.int32)
        pos = pos + 1
    chunk = _tokens((2, 8), cfg_t.vocab_size, seed=2)
    cpos = np.broadcast_to(np.arange(max_len - 4, max_len + 4)[None],
                           (2, 8)).astype(np.int32)
    logits_j, cache = model_j.apply(
        {'params': params_j, 'cache': cache['cache']}, chunk,
        positions=cpos, decode=True, mutable=('cache',))
    with torch.no_grad():
        logits_t, cache_t = model_t(torch.from_numpy(chunk),
                                    torch.from_numpy(cpos), decode=True,
                                    cache=cache_t)
    np.testing.assert_allclose(logits_t[:, :4].numpy(),
                               np.asarray(logits_j)[:, :4],
                               atol=F32_ATOL, rtol=0)
    for i in range(cfg_t.n_layers):
        kv_j = cache['cache'][f'layer_{i}']['attn']
        np.testing.assert_allclose(cache_t[i][0].numpy(),
                                   np.asarray(kv_j['k']), atol=F32_ATOL)
        np.testing.assert_allclose(cache_t[i][1].numpy(),
                                   np.asarray(kv_j['v']), atol=F32_ATOL)


def test_bf16_greedy_tokens_match_flax():
    """Default bf16 compute with f32 params: bf16 rounds at other places
    in the two frameworks, so this is judged on greedy tokens, not on
    logits."""
    cfg_j, cfg_t = _configs('tiny', dtype_j=jnp.bfloat16,
                            dtype_t=torch.bfloat16)
    model_j, params_j, model_t = _models(cfg_j, cfg_t)
    toks = _tokens((4, 24), cfg_t.vocab_size, seed=3)
    want = np.asarray(jnp.argmax(
        model_j.apply({'params': params_j}, toks)[:, -1], -1))
    with torch.no_grad():
        got = torch.argmax(model_t(torch.from_numpy(toks))[:, -1],
                           -1).numpy()
    np.testing.assert_array_equal(got, want)


def test_init_params_shapes_and_dtype():
    cfg = dataclasses.replace(tl.LLAMA_CONFIGS['tiny'],
                              param_dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    params = tl.init_params(cfg, 'cpu', gen)
    model = tl.Llama(cfg, params)
    assert all(p.dtype == torch.bfloat16 and p.device.type == 'cpu'
               for p in model.parameters())
    assert sum(p.numel() for p in model.parameters()) == cfg.num_params()
    # Modules built over one dict share it (no copy).
    xla = tl.Llama(dataclasses.replace(cfg, attention_impl='xla'), params)
    assert xla.embed.weight.data_ptr() == model.embed.weight.data_ptr()
