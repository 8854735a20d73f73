"""The port's encoder classifier and ResNet against the Flax models (mirrors
tests/test_models_zoo.py): `tiny` of each, weights converted from the
Flax trees, f32 compute on both sides, inputs from seeded numpy.  Logits
and gradients within 1e-4; ResNet's running statistics after one
train-mode step within 1e-5 (flax keeps the BIASED batch variance);
train=False logits through the running averages; and flax's asymmetric
SAME padding of the 7x7/2 stem, a 3x3/2 conv and the -inf-padded max
pool on even and odd inputs."""
import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from skypilot_tpu.models import encoder as je
from skypilot_tpu.models import resnet as jr
from skypilot_tpu_torch.models import encoder as te
from skypilot_tpu_torch.models import resnet as tr
from skypilot_tpu_torch.models.convert import (encoder_params_from_jax,
                                               resnet_state_from_jax)

torch.set_num_threads(1)

TOL = 1e-4                 # logits and gradients, f32 on both sides
STATS_TOL = 1e-5           # running mean and variance after one step


def _np(tree):
    return jax.tree.map(np.asarray, meta.unbox(tree))


def _rng(seed):
    return np.random.default_rng(seed)


# ----- encoder ---------------------------------------------------------------
ENC_J = dataclasses.replace(je.ENCODER_CONFIGS['tiny'], dtype=jnp.float32)
ENC_T = dataclasses.replace(te.ENCODER_CONFIGS['tiny'], dtype=torch.float32)


@pytest.fixture(scope='module')
def encoders():
    model_j = je.EncoderClassifier(ENC_J)
    tokens = _rng(0).integers(0, ENC_T.vocab_size, (3, 16)).astype(np.int32)
    params = _np(model_j.init(jax.random.PRNGKey(0), tokens)['params'])
    model_t = te.EncoderClassifier(ENC_T, encoder_params_from_jax(params))
    return model_j, params, model_t, tokens


def test_encoder_logits_match_flax(encoders):
    model_j, params, model_t, tokens = encoders
    want = np.asarray(model_j.apply({'params': params}, tokens))
    with torch.no_grad():
        got = model_t(torch.from_numpy(tokens)).numpy()
    assert got.dtype == np.float32 and got.shape == (3, ENC_T.num_classes)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_encoder_grads_match_flax(encoders):
    model_j, params, model_t, tokens = encoders
    r = _rng(1).standard_normal((3, ENC_T.num_classes)).astype(np.float32)
    g = jax.grad(lambda p: jnp.sum(model_j.apply({'params': p}, tokens) *
                                   r))(params)
    want = encoder_params_from_jax(_np(g))
    model_t.requires_grad_(True)
    try:
        (model_t(torch.from_numpy(tokens)) * torch.from_numpy(r)).sum(
        ).backward()
        grads = {n: p.grad for n, p in model_t.named_parameters()}
    finally:
        model_t.requires_grad_(False)
        model_t.zero_grad(set_to_none=True)
    assert set(grads) == set(want)
    for name, grad in grads.items():
        np.testing.assert_allclose(grad.numpy(), want[name].numpy(),
                                   atol=TOL, rtol=0, err_msg=name)


def test_encoder_is_bidirectional(encoders):
    """Non-causal attention: changing the last token changes the first
    position's output of a block."""
    _, _, model_t, tokens = encoders
    other = tokens.copy()
    other[:, -1] = (other[:, -1] + 1) % ENC_T.vocab_size
    with torch.no_grad():
        a = model_t.blocks[0](model_t.tok_embed.weight[
            torch.from_numpy(tokens)])
        b = model_t.blocks[0](model_t.tok_embed.weight[
            torch.from_numpy(other)])
    assert not torch.allclose(a[:, 0], b[:, 0])


# ----- ResNet ----------------------------------------------------------------
RES_J = dataclasses.replace(jr.RESNET_CONFIGS['tiny'], dtype=jnp.float32)
RES_T = dataclasses.replace(tr.RESNET_CONFIGS['tiny'], dtype=torch.float32)


def _images(seed=2, hw=32):
    return _rng(seed).standard_normal((2, hw, hw, 3)).astype(np.float32)


@pytest.fixture(scope='module')
def resnets():
    """(Flax model, its variables, the converted state) at a random
    (not the initial) running average, so train=False reads something
    other than mean 0, variance 1."""
    model_j = jr.ResNet(RES_J)
    x = _images()
    variables = _np(model_j.init(jax.random.PRNGKey(0), x))
    stats = jax.tree.map(
        lambda a: np.abs(_rng(a.size).standard_normal(a.shape)).astype(
            np.float32) + 0.5, variables['batch_stats'])
    variables = {'params': variables['params'], 'batch_stats': stats}
    return model_j, variables, x


def _resnet_t(variables):
    return tr.ResNet(RES_T, resnet_state_from_jax(variables['params'],
                                                  variables['batch_stats']))


@pytest.mark.parametrize('hw', [32, 33])
def test_resnet_train_step_logits_and_stats_match_flax(resnets, hw):
    """One train-mode forward: logits within 1e-4, and the running mean
    and variance flax returns in `batch_stats` within 1e-5."""
    model_j, variables, _ = resnets
    x = _images(seed=hw, hw=hw)
    want, new = model_j.apply(variables, x, mutable=['batch_stats'])
    model_t = _resnet_t(variables)
    with torch.no_grad():
        got = model_t(torch.from_numpy(x), train=True).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)
    want_state = resnet_state_from_jax(variables['params'],
                                       _np(new['batch_stats']))
    state = model_t.state_dict()
    n_stats = 0
    for name, value in want_state.items():
        if name.endswith(('.mean', '.var')):
            np.testing.assert_allclose(state[name].numpy(), value.numpy(),
                                       atol=STATS_TOL, rtol=0, err_msg=name)
            n_stats += 1
    assert n_stats == 2 * (1 + 3 + 3 + 1 + 1)   # stem, 2 blocks + projections


def test_resnet_eval_logits_use_running_averages(resnets):
    model_j, variables, x = resnets
    want = np.asarray(model_j.apply(variables, x, train=False))
    model_t = _resnet_t(variables)
    before = {k: v.clone() for k, v in model_t.state_dict().items()}
    with torch.no_grad():
        got = model_t(torch.from_numpy(x), train=False).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    for name, value in model_t.state_dict().items():
        assert torch.equal(value, before[name]), name


def test_resnet_grads_match_flax(resnets):
    """Gradients of a train-mode step (through the batch statistics)."""
    model_j, variables, x = resnets
    r = _rng(3).standard_normal((2, RES_T.num_classes)).astype(np.float32)

    def loss(p):
        out, _ = model_j.apply({'params': p,
                                'batch_stats': variables['batch_stats']},
                               x, mutable=['batch_stats'])
        return jnp.sum(out * r)

    g = jax.grad(loss)(variables['params'])
    want = resnet_state_from_jax(_np(g), variables['batch_stats'])
    model_t = _resnet_t(variables).requires_grad_(True)
    (model_t(torch.from_numpy(x), train=True) *
     torch.from_numpy(r)).sum().backward()
    grads = {n: p.grad for n, p in model_t.named_parameters()}
    assert set(grads) == {k for k in want
                          if not k.endswith(('.mean', '.var'))}
    for name, grad in grads.items():
        np.testing.assert_allclose(grad.numpy(), want[name].numpy(),
                                   atol=TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize('kernel,stride,hw', [(7, 2, 16), (3, 2, 16),
                                              (7, 2, 15), (3, 2, 15),
                                              (3, 1, 16), (1, 2, 16)])
def test_same_padding_matches_flax_conv(kernel, stride, hw):
    """Flax's SAME pads (2, 3) for the 7x7/2 stem and (0, 1) for a 3x3/2
    conv on an even size; a symmetric k//2 pad shifts every output."""
    x = _rng(kernel * hw).standard_normal((1, hw, hw, 3)).astype(np.float32)
    conv_j = fnn.Conv(4, (kernel, kernel), (stride, stride), padding='SAME',
                      use_bias=False, dtype=jnp.float32)
    params = _np(conv_j.init(jax.random.PRNGKey(1), x)['params'])
    want = np.asarray(conv_j.apply({'params': params}, x))
    conv_t = tr.Conv(3, 4, kernel, stride, torch.float32, torch.float32)
    conv_t.load_state_dict({'weight': torch.from_numpy(
        params['kernel'].transpose(3, 2, 0, 1).copy())}, assign=True)
    with torch.no_grad():
        got = conv_t(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5, rtol=0)
    if (kernel, stride, hw) == (7, 2, 16):
        assert tr.same_padding(hw, 7, 2) == (2, 3)
    if (kernel, stride, hw) == (3, 2, 16):
        assert tr.same_padding(hw, 3, 2) == (0, 1)


@pytest.mark.parametrize('hw', [16, 15])
def test_max_pool_pads_with_minus_inf(hw):
    """All-negative input: a zero pad would win the border windows."""
    x = -np.abs(_rng(hw).standard_normal((1, hw, hw, 2))).astype(
        np.float32) - 1.0
    want = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), (2, 2),
                                   padding='SAME'))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = torch.nn.functional.max_pool2d(
        tr._pad_same(xt, 3, 2, float('-inf')), 3, 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize('which', ['encoder', 'resnet'])
def test_init_params_build_runnable_models(which, monkeypatch):
    """init_params on the CPU when asked; on no device, it needs CUDA."""
    if which == 'encoder':
        cfg, lib = te.ENCODER_CONFIGS['tiny'], te
        model = te.EncoderClassifier(cfg, te.init_params(cfg, 'cpu'))
        out = model(torch.zeros((2, 8), dtype=torch.long))
    else:
        cfg, lib = tr.RESNET_CONFIGS['tiny'], tr
        model = tr.ResNet(cfg, tr.init_params(cfg, 'cpu'))
        out = model(torch.zeros((2, 16, 16, 3)), train=False)
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        lib.init_params(cfg)
