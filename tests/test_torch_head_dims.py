"""A port Llama at attention widths outside the port's first kernels'
(head_dim 96, Phi-3-mini's, and 256, Gemma's; on the card they take the
wide mma.sync kernels, and the backward at 256 its wgmma kernels) against
the Flax model on the same weights
(converted by `models/convert.py`): full-forward logits, one training
step's loss and per-tensor gradients, and the dense engine's greedy
tokens against the JAX model's.  Two layers, 2 query heads over 1 kv head,
narrow widths; f32 compute on both sides.  On the CPU the port's flash
path is its kernels' plain versions, so this holds the slice's
arithmetic (the padding, routing and kernels are the card's and
`tests/test_torch_ops.py`'s); inputs come from seeded numpy generators and
go to both frameworks as numpy; JAX stays on the CPU."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from skypilot_tpu.models import llama as jl
from skypilot_tpu.train import trainer as jt
from skypilot_tpu_torch.inference.engine import DecodeEngine, EngineConfig
from skypilot_tpu_torch.models import llama as tl
from skypilot_tpu_torch.models.convert import params_from_jax
from skypilot_tpu_torch.ops.cuda import flash_attention as fa
from skypilot_tpu_torch.train import trainer as tt

torch.set_num_threads(1)

# head_dim -> the config: dim = 2 heads x head_dim, one kv head (MQA, as
# Gemma-2B's), 2 layers, untied lm_head.
WIDTHS = {96: dict(dim=192, ffn_dim=256), 256: dict(dim=512, ffn_dim=512)}
BASE = dict(vocab_size=512, n_layers=2, n_heads=2, n_kv_heads=1,
            rope_theta=10000.0, max_seq_len=64, remat=False)
# f32 compute on both sides: differences are summation order only
# (tests/test_torch_llama.py's logits tolerance).
F32_ATOL = 1e-4
# One step's loss and global grad norm (tests/test_torch_train.py's
# trainer parity), and each gradient tensor against the JAX gradient,
# relative to that tensor's largest entry.
LOSS_RTOL, NORM_RTOL, GRAD_RTOL = 1e-5, 1e-4, 1e-4


@functools.lru_cache(maxsize=None)
def _models(head_dim):
    kw = dict(BASE, **WIDTHS[head_dim])
    cfg_j = dataclasses.replace(jl.LlamaConfig(**kw), dtype=jnp.float32)
    cfg_t = dataclasses.replace(tl.LlamaConfig(**kw), dtype=torch.float32)
    assert cfg_t.head_dim == head_dim and fa.kernel_width(head_dim) == (
        head_dim)
    model_j = jl.Llama(cfg_j)
    params_j = meta.unbox(jax.jit(model_j.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))['params'])
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j))
    return model_j, params_j, cfg_t, params_t


def _global_norm(grads) -> float:
    return float(torch.stack([g.norm() for g in grads.values()]).norm())


def _tokens(shape, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab,
                                                shape).astype(np.int32)


@pytest.mark.parametrize('head_dim', sorted(WIDTHS))
def test_logits_match_flax(head_dim):
    model_j, params_j, cfg_t, params_t = _models(head_dim)
    toks = _tokens((2, 32), cfg_t.vocab_size)
    want = np.asarray(jax.jit(model_j.apply)({'params': params_j}, toks))
    with torch.no_grad():
        got = tl.Llama(cfg_t, params_t)(torch.from_numpy(toks)).numpy()
    assert got.shape == want.shape == (2, 32, cfg_t.vocab_size)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize('head_dim', sorted(WIDTHS))
def test_train_step_loss_and_grads_match_flax(head_dim):
    """The next-token loss and its gradient with respect to every
    parameter, through the port's flash op (its backward the dq and dk/dv
    kernels' plain versions on the CPU) and through JAX's value_and_grad,
    on the same weights and batch."""
    model_j, params_j, cfg_t, params_t = _models(head_dim)
    toks = _tokens((4, 32), cfg_t.vocab_size, seed=2)

    def loss_j(params):
        return jt.lm_loss(model_j.apply({'params': params}, toks), toks)

    loss_want, grads_j = jax.jit(jax.value_and_grad(loss_j))(params_j)
    want = params_from_jax(jax.tree.map(np.asarray, grads_j))
    model = tl.Llama(cfg_t, {n: p.clone() for n, p in params_t.items()}
                     ).requires_grad_(True)
    names, params = zip(*model.named_parameters())
    loss = tt.lm_loss(model(torch.from_numpy(toks)), torch.from_numpy(toks))
    got = dict(zip(names, torch.autograd.grad(loss, params)))
    np.testing.assert_allclose(loss.item(), float(loss_want),
                               rtol=LOSS_RTOL)
    assert set(got) == set(want)
    np.testing.assert_allclose(_global_norm(got), _global_norm(want),
                               rtol=NORM_RTOL)
    for name, ref in want.items():
        scale = float(ref.abs().max())
        np.testing.assert_allclose(got[name].numpy(), ref.numpy(),
                                   atol=GRAD_RTOL * scale, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize('head_dim', sorted(WIDTHS))
def test_engine_greedy_tokens_match_flax(head_dim):
    """The dense engine's greedy tokens (prefill through the flash op,
    decode steps on the cache) equal the JAX model's, each step a full
    forward over the growing sequence."""
    model_j, params_j, cfg_t, params_t = _models(head_dim)
    apply = jax.jit(lambda t: model_j.apply({'params': params_j}, t))
    engine = DecodeEngine(tl.Llama(cfg_t, params_t),
                          EngineConfig(n_slots=2, prefill_buckets=(16,)),
                          device='cpu')
    prompts = [_tokens((9,), cfg_t.vocab_size, seed=3).tolist(),
               _tokens((13,), cfg_t.vocab_size, seed=4).tolist()]
    n_new = 6
    reqs = [engine.submit(p, n_new) for p in prompts]
    for _ in range(200):
        engine.step()
        if all(r.finished_at is not None for r in reqs):
            break
    for prompt, req in zip(prompts, reqs):
        ids = list(prompt)
        for _ in range(n_new):
            buf = np.zeros((1, 32), np.int32)
            buf[0, :len(ids)] = ids
            ids.append(int(jnp.argmax(apply(buf)[0, len(ids) - 1])))
        assert req.tokens() == ids[len(prompt):]
