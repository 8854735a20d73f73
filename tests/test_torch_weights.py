"""Serving trained checkpoints in the port (`inference/weights.py`, the
server's `--checkpoint` / `--param-dtype`): JAX `tiny` weights carried
across with `params_from_jax`, saved as a port `TrainState` by the
port's `CheckpointManager`, restored leaf-exact, and served with the
JAX engine's greedy tokens on the same weights.  f32 compute on both
sides so greedy argmax is not at the mercy of bf16 rounding."""
import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from skypilot_tpu.data import storage as jax_storage
from skypilot_tpu.inference import engine as jax_engine
from skypilot_tpu.inference import weights as jax_weights
from skypilot_tpu.models import llama as jl
from skypilot_tpu_torch.inference import server as torch_server
from skypilot_tpu_torch.inference.engine import DecodeEngine, EngineConfig
from skypilot_tpu_torch.inference import weights as torch_weights
from skypilot_tpu_torch.inference.weights import load_serving_params
from skypilot_tpu_torch.models import llama as tl
from skypilot_tpu_torch.models.convert import params_from_jax
from skypilot_tpu_torch.train import trainer as tt
from skypilot_tpu_torch.train.checkpoint import CheckpointManager

torch.set_num_threads(1)

CFG_J = dataclasses.replace(jl.LLAMA_CONFIGS['tiny'], dtype=jnp.float32)
CFG_T = dataclasses.replace(tl.LLAMA_CONFIGS['tiny'], dtype=torch.float32)
ENGINE_KW = dict(n_slots=2, prefill_buckets=(8, 16), steps_per_call=4)
PROMPTS = [[5, 17, 3, 42, 9], [7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 200]]


class _ParamsOnly:
    """A params-only checkpoint: `state_dict()` is the tensors alone."""

    def __init__(self, tensors):
        self.tensors = tensors

    def state_dict(self):
        return self.tensors


@pytest.fixture(scope='module')
def saved(tmp_path_factory):
    """(JAX model, JAX params, port params, checkpoint dir): the JAX
    weights saved as a full TrainState at step 3, after a params-only
    step 1 of other weights."""
    model_j = jl.Llama(CFG_J)
    params_j = meta.unbox(jax.jit(model_j.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))['params'])
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j))
    directory = str(tmp_path_factory.mktemp('ckpt'))
    mgr = CheckpointManager(directory)
    mgr.save(1, _ParamsOnly({k: torch.zeros_like(v)
                             for k, v in params_t.items()}))
    model = tl.Llama(CFG_T, {k: v.clone() for k, v in params_t.items()})
    mgr.save(3, tt.make_train_state(model, tt.TrainConfig()))
    return model_j, params_j, params_t, directory


def _run(engine, reqs, limit=400):
    for _ in range(limit):
        engine.step()
        if all(r.finished_at is not None for r in reqs):
            return [r.tokens() for r in reqs]
    raise AssertionError('requests did not finish')


def test_load_restores_train_state_leaf_exact(saved):
    _, _, params_t, directory = saved
    got = load_serving_params(directory, device='cpu')       # latest: 3
    assert sorted(got) == sorted(params_t)
    for name, want in params_t.items():
        assert got[name].dtype == want.dtype
        torch.testing.assert_close(got[name], want, rtol=0, atol=0)
    # An explicit step reads that step: the params-only zeros.
    first = load_serving_params(directory, step=1, device='cpu')
    assert list(first) == list(params_t)
    assert all(not t.any() for t in first.values())


def test_restored_checkpoint_serves_jax_greedy_tokens(saved):
    model_j, params_j, _, directory = saved
    model = tl.Llama(CFG_T, load_serving_params(directory, device='cpu'))
    engine = DecodeEngine(model, EngineConfig(**ENGINE_KW), device='cpu')
    got = _run(engine, [engine.submit(p, 8) for p in PROMPTS])
    ref = jax_engine.DecodeEngine(model_j, params_j,
                                  jax_engine.EngineConfig(**ENGINE_KW))
    reqs = [ref.submit(p, 8) for p in PROMPTS]
    for _ in range(400):
        ref.step()
        if all(r.finished_at is not None for r in reqs):
            break
    assert got == [r.tokens() for r in reqs]


def test_dtype_casts_floating_tensors_only(tmp_path):
    tensors = {'w': torch.randn(3, 4), 'ids': torch.arange(5),
               'mask': torch.tensor([True, False])}
    CheckpointManager(str(tmp_path)).save(0, _ParamsOnly(tensors))
    got = load_serving_params(str(tmp_path), dtype=torch.bfloat16,
                              device='cpu')
    assert got['w'].dtype == torch.bfloat16
    torch.testing.assert_close(got['w'], tensors['w'].to(torch.bfloat16),
                               rtol=0, atol=0)
    assert got['ids'].dtype == torch.int64
    assert torch.equal(got['ids'], tensors['ids'])
    assert got['mask'].dtype == torch.bool


def test_missing_steps_and_buckets_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match='no checkpoint steps'):
        load_serving_params(str(tmp_path), device='cpu')
    with pytest.raises(FileNotFoundError, match='no checkpoint directory'):
        load_serving_params(str(tmp_path / 'absent'), device='cpu')


def test_missing_gs_bucket_raises_and_leaves_no_download(gcs):
    """A gs:// path with nothing under it is fetched (to an empty temp
    directory), raises as an empty local directory does, and the temp
    directory is gone afterwards."""
    with pytest.raises(FileNotFoundError, match='no checkpoint steps'):
        load_serving_params('gs://absent-bucket/run-1', device='cpu')
    assert os.listdir(gcs['tmp']) == []


@pytest.mark.parametrize('param_dtype', [None, 'float32', 'bfloat16'])
def test_server_builds_the_checkpointed_model(saved, param_dtype):
    _, _, params_t, directory = saved
    argv = ['--model', 'tiny', '--device', 'cpu', '--max-seq-len', '128',
            '--checkpoint', directory]
    if param_dtype:
        argv += ['--param-dtype', param_dtype]
    model = torch_server.build_model(torch_server.parse_args(argv))
    want_dtype = getattr(torch, param_dtype or 'float32')
    assert model.cfg.param_dtype == want_dtype
    assert model.cfg.max_seq_len == 128
    got = model.state_dict()
    assert sorted(got) == sorted(params_t)
    for name, want in params_t.items():
        torch.testing.assert_close(got[name], want.to(want_dtype), rtol=0,
                                   atol=0)


def test_server_without_checkpoint_serves_seeded_random_weights():
    argv = ['--model', 'tiny', '--device', 'cpu', '--param-dtype',
            'bfloat16', '--seed', '4']
    a, b = (torch_server.build_model(torch_server.parse_args(argv))
            for _ in range(2))
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert x.dtype == torch.bfloat16, name
        assert torch.equal(x, y), name


# ----- gs:// checkpoints (through the fake-GCS root) -------------------------


@pytest.fixture
def gcs(saved, tmp_path, monkeypatch):
    """The saved checkpoint uploaded to gs://ckpts/run-1 under a fake-GCS
    root (by the JAX package's GcsStore, so the port's fetch reads what
    the JAX storage layer wrote), and a private temp directory that the
    fetch's downloads land in."""
    monkeypatch.setenv('SKYTPU_FAKE_GCS_ROOT', str(tmp_path / 'gcs'))
    downloads = tmp_path / 'tmp'
    downloads.mkdir()
    monkeypatch.setattr(tempfile, 'tempdir', str(downloads))
    store = jax_storage.GcsStore('ckpts')
    store.create()
    store.sync_up(saved[3], 'run-1')
    return {'url': 'gs://ckpts/run-1', 'tmp': str(downloads),
            'dir': saved[3]}


def test_gs_load_equals_local_load_and_cleans_up(gcs):
    got = load_serving_params(gcs['url'], device='cpu')
    want = load_serving_params(gcs['dir'], device='cpu')
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)
    first = load_serving_params(gcs['url'], step=1, device='cpu',
                                dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 and not t.any()
               for t in first.values())
    assert os.listdir(gcs['tmp']) == []


def test_gs_fetch_matches_the_jax_fetch(gcs):
    """The port's `_materialize_local` downloads the same files as the JAX
    package's; both hand local paths back untouched, and both remove
    only what they fetched."""
    fetched = {}
    for name, lib in (('jax', jax_weights), ('torch', torch_weights)):
        local = lib._materialize_local(gcs['url'])
        assert local.startswith(gcs['tmp'])
        fetched[name] = sorted(
            os.path.relpath(os.path.join(d, f), local)
            for d, _, files in os.walk(local) for f in files)
        lib._cleanup_fetched(gcs['url'], local)
        assert not os.path.exists(local)
        assert lib._materialize_local(gcs['dir']) == gcs['dir']
        lib._cleanup_fetched(gcs['dir'], gcs['dir'])
        assert os.path.isdir(gcs['dir'])
    assert fetched['torch'] == fetched['jax'] and fetched['torch']


def test_gs_load_removes_the_download_after_a_failure(gcs, monkeypatch):
    def broken(self, step, box=None):
        raise RuntimeError('read failed')

    monkeypatch.setattr(CheckpointManager, 'read_params', broken)
    with pytest.raises(RuntimeError, match='read failed'):
        load_serving_params(gcs['url'], device='cpu')
    assert os.listdir(gcs['tmp']) == []


def test_server_builds_from_a_gs_checkpoint(gcs, saved):
    """`--checkpoint gs://...` builds the same model as the local path,
    and serves the JAX engine's greedy tokens on those weights."""
    model_j, params_j, params_t, _ = saved
    argv = ['--model', 'tiny', '--device', 'cpu', '--max-seq-len', '128',
            '--checkpoint', gcs['url']]
    model = torch_server.build_model(torch_server.parse_args(argv))
    got = model.state_dict()
    assert sorted(got) == sorted(params_t)
    for name, want in params_t.items():
        torch.testing.assert_close(got[name], want, rtol=0, atol=0)
    assert os.listdir(gcs['tmp']) == []
    model = tl.Llama(CFG_T, {k: v.clone() for k, v in got.items()})
    engine = DecodeEngine(model, EngineConfig(**ENGINE_KW), device='cpu')
    toks = _run(engine, [engine.submit(p, 8) for p in PROMPTS])
    ref = jax_engine.DecodeEngine(model_j, params_j,
                                  jax_engine.EngineConfig(**ENGINE_KW))
    reqs = [ref.submit(p, 8) for p in PROMPTS]
    for _ in range(400):
        ref.step()
        if all(r.finished_at is not None for r in reqs):
            break
    assert toks == [r.tokens() for r in reqs]
