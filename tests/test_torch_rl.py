"""The port's RL primitives (`train/rl.py`) against the JAX package's
(`skypilot_tpu/train/rl.py`) on the same numpy inputs: the log-prob
math, the masked REINFORCE loss (unequal per-row lengths, with and
without the KL term), whitening, and one REINFORCE step on `tiny`
(`optax.adam` against `torch.optim.Adam` at the same rate).  Then
tests/test_rl.py's end-to-end cases mirrored on the port engine: per-row
lengths from a rollout, and an SGD step that raises the +1-advantage
row's log-prob and lowers the -1 row's, the engine serving on after
`update_params`.  f32 compute on both sides."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import meta

from skypilot_tpu.models import llama as jl
from skypilot_tpu.train import rl as jrl
from skypilot_tpu_torch.inference.engine import DecodeEngine, EngineConfig
from skypilot_tpu_torch.models import llama as tl
from skypilot_tpu_torch.models.convert import params_from_jax
from skypilot_tpu_torch.train import rl as trl

torch.set_num_threads(1)

CFG_J = dataclasses.replace(jl.LLAMA_CONFIGS['tiny'], dtype=jnp.float32)
CFG_T = dataclasses.replace(tl.LLAMA_CONFIGS['tiny'], dtype=torch.float32)
# f32 on both sides; the functions differ only in the order of f32 sums.
RL_RTOL = 1e-5
# One Adam step from the same weights on f32 gradients that differ in
# summation order (~5e-7 relative over the whole gradient): Adam's first
# step moves a parameter by lr * g / (|g| + eps), about lr wherever g is
# well above eps, so almost every parameter agrees within 1e-5 and the
# few whose gradient is near eps (1e-8, where the REINFORCE sum over
# +-advantages cancels) within 1e-4: the bounds tests/test_torch_train.py
# holds the train step to.  The rate is 1e-3 (the recipe's is 1e-5): a
# step of 1e-3 is 100x the per-parameter bound, and the eps-sized
# gradients' noise, ~1e-2 of lr, stays inside the outlier bound.
STEP_LR = 1e-3
STEP_LOSS_RTOL, STEP_PARAM_ATOL = 1e-5, 1e-5
STEP_PARAM_ATOL_ALL, STEP_PARAM_OUTLIER_SHARE = 1e-4, 1e-3
# (prompt_lens, total_lens) of a padded batch of 4 rows of 12 tokens.
PROMPT_LENS = np.array([2, 3, 5, 1], np.int32)
TOTAL_LENS = np.array([12, 9, 10, 7], np.int32)


@pytest.fixture(scope='module')
def models():
    model_j = jl.Llama(CFG_J)
    params_j = meta.unbox(jax.jit(model_j.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))['params'])
    return model_j, params_j, params_from_jax(jax.tree.map(np.asarray,
                                                           params_j))


def _batch(seed=0, b=4, s=12, v=11):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, s, v)).astype(np.float32) * 3
    tokens = rng.integers(0, v, (b, s)).astype(np.int32)
    for i, t in enumerate(TOTAL_LENS[:b]):
        tokens[i, t:] = 0                          # zero padding
    adv = rng.standard_normal(b).astype(np.float32)
    ref = rng.standard_normal((b, s - 1)).astype(np.float32) - 2.0
    return logits, tokens, adv, ref


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_sequence_logprobs_matches_jax():
    logits, tokens, _, _ = _batch()
    want = np.asarray(jrl.sequence_logprobs(jnp.asarray(logits),
                                            jnp.asarray(tokens)))
    got = trl.sequence_logprobs(_t(logits), _t(tokens)).numpy()
    assert got.shape == (4, 11) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RL_RTOL, atol=0)


@pytest.mark.parametrize('kl_coef', [0.0, 0.02, 0.5])
@pytest.mark.parametrize('with_ref', [False, True])
def test_reinforce_loss_matches_jax(kl_coef, with_ref):
    logits, tokens, adv, ref = _batch(seed=1)
    args_j = [jnp.asarray(x) for x in (logits, tokens, adv, PROMPT_LENS,
                                       TOTAL_LENS)]
    args_t = [_t(x) for x in (logits, tokens, adv, PROMPT_LENS,
                              TOTAL_LENS)]
    want = float(jrl.reinforce_loss(
        *args_j, ref_logprobs=jnp.asarray(ref) if with_ref else None,
        kl_coef=kl_coef))
    got = float(trl.reinforce_loss(
        *args_t, ref_logprobs=_t(ref) if with_ref else None,
        kl_coef=kl_coef))
    np.testing.assert_allclose(got, want, rtol=RL_RTOL)


def test_reinforce_loss_masks_prompt_and_padding():
    """Only [prompt_len, total_len) contributes, per row: a row whose
    window is empty equals dropping it (tests/test_rl.py's case)."""
    logits, tokens, adv, _ = _batch(seed=2, b=2, s=6, v=7)
    adv[:] = 1.0
    only_row0 = trl.reinforce_loss(_t(logits[:1]), _t(tokens[:1]),
                                   _t(adv[:1]), _t([4]), _t([6]))
    row1_empty = trl.reinforce_loss(_t(logits), _t(tokens), _t(adv),
                                    _t([4, 6]), _t([6, 6]))
    np.testing.assert_allclose(float(row1_empty), float(only_row0),
                               rtol=1e-6)


@pytest.mark.parametrize('rewards', [[1.0, 2.0, 3.0, 7.5], [2.0, 2.0]])
def test_whiten_matches_jax(rewards):
    got = trl.whiten(rewards)
    np.testing.assert_allclose(got, jrl.whiten(rewards), rtol=RL_RTOL,
                               atol=1e-7)
    assert np.all(np.isfinite(got))


def test_reinforce_step_matches_jax_adam(models):
    """One REINFORCE step (kl term on) from the same weights: optax.adam
    against torch.optim.Adam at the same rate."""
    model_j, params_j, params_t = models
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, CFG_T.vocab_size, (4, 12)).astype(np.int32)
    for i, t in enumerate(TOTAL_LENS):
        tokens[i, t:] = 0
    adv = trl.whiten(rng.standard_normal(4))
    ref = (rng.standard_normal((4, 11)) - 5.0).astype(np.float32)
    lr, kl = STEP_LR, 0.02
    tx = optax.adam(lr)
    step_j = jrl.make_reinforce_step(model_j, tx, kl_coef=kl)
    new_j, _, loss_j = step_j(params_j, tx.init(params_j),
                              jnp.asarray(tokens), jnp.asarray(adv),
                              jnp.asarray(PROMPT_LENS),
                              jnp.asarray(TOTAL_LENS), jnp.asarray(ref))
    model = tl.Llama(CFG_T, {k: v.clone() for k, v in params_t.items()})
    step_t = trl.make_reinforce_step(
        model, torch.optim.Adam(model.parameters(), lr=lr), kl_coef=kl)
    loss_t = step_t(tokens, adv, PROMPT_LENS, TOTAL_LENS, ref)
    np.testing.assert_allclose(float(loss_t), float(loss_j),
                               rtol=STEP_LOSS_RTOL)
    want = params_from_jax(jax.tree.map(np.asarray, meta.unbox(new_j)))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    moved = 0
    for name in want:
        diff = np.abs(got[name].numpy() - want[name].numpy())
        assert diff.max() <= STEP_PARAM_ATOL_ALL, (name, diff.max())
        assert ((diff > STEP_PARAM_ATOL).mean() <=
                STEP_PARAM_OUTLIER_SHARE), name
        # Every tensor took a step well above the bounds.
        moved += int((got[name] - params_t[name]).abs().max() >= lr / 2)
    assert moved == len(want)


def _engine(model, seed):
    return DecodeEngine(model, EngineConfig(
        n_slots=2, steps_per_call=3, prefill_buckets=(8,),
        temperature=1.0, seed=seed), device='cpu')


def test_rollout_reports_per_row_lengths(models):
    _, _, params_t = models
    engine = _engine(tl.Llama(CFG_T, params_t), seed=3)
    prompts = [[1, 2], [3, 4, 5, 6]]          # unequal prompts
    toks, adv, plens, tlens = trl.rollout(
        engine, prompts, 4, lambda p, s: float(len(s)))
    assert list(plens) == [2, 4]
    assert list(tlens) == [6, 8]
    assert toks.shape == (2, 8)
    assert np.all(toks[0, 6:] == 0)           # row 0 padded
    assert list(toks[1, :4]) == [3, 4, 5, 6]
    assert np.all(np.isfinite(adv))


def test_reinforce_update_moves_logprobs_by_advantage(models):
    """The actor-learner round trip on `tiny`: ONE engine for the whole
    loop (weights swapped with update_params), a rollout sampled on the
    engine, one REINFORCE step with SGD on the learner's own copy.  A
    small SGD step RAISES the +1-advantage row's sequence log-prob and
    LOWERS the -1 row's (first order, no sampling luck)."""
    _, _, params_t = models
    engine = _engine(tl.Llama(CFG_T, {k: v.clone()
                                      for k, v in params_t.items()}), seed=7)
    learner = tl.Llama(CFG_T, {k: v.clone() for k, v in params_t.items()})
    prompts = [[1, 2, 3], [4, 5, 6]]
    max_new = 6
    toks, _, plens, tlens = trl.rollout(engine, prompts, max_new,
                                        lambda p, s: 0.0)
    toks_t = torch.from_numpy(toks).long()
    adv = np.array([1.0, -1.0], np.float32)

    def masked_row_logprobs():
        with torch.no_grad():
            lp = trl.sequence_logprobs(learner(toks_t), toks_t)
        pos = torch.arange(toks.shape[1] - 1)[None, :]
        mask = ((pos >= _t(plens)[:, None] - 1) &
                (pos < _t(tlens)[:, None] - 1))
        return (lp * mask).sum(dim=1).numpy()

    before = masked_row_logprobs()
    step = trl.make_reinforce_step(
        learner, torch.optim.SGD(learner.parameters(), lr=1e-2))
    loss = step(toks, adv, plens, tlens)
    assert np.isfinite(float(loss))
    after = masked_row_logprobs()
    assert after[0] > before[0]     # +1 advantage: more likely
    assert after[1] < before[1]     # -1 advantage: less likely

    # The engine keeps serving with the learner's weights (no rebuild),
    # a copy of them: the learner's next update does not reach it.
    engine.update_params(learner.state_dict())
    served = engine.model.state_dict()
    assert all(torch.equal(served[k], v)
               for k, v in learner.state_dict().items())
    toks2, _, p2, t2 = trl.rollout(engine, prompts, max_new,
                                   lambda p, s: 0.0)
    assert toks2.shape[0] == 2 and list(p2) == [3, 3]
    assert all(t >= 3 for t in t2)
