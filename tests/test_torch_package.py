"""Isolation and no-fallback rules of the PyTorch port (skypilot_tpu_torch):
it imports neither JAX nor the JAX package, its entry points refuse to
run without CUDA unless told to use the CPU, and its copies of the JAX
package's JAX-free modules stay verbatim apart from import lines."""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / 'skypilot_tpu_torch'
COPIED = ['sky_logging.py', 'utils/timeline.py', 'server/metrics.py',
          'server/tracing.py']


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob('*.py')):
        rel = path.relative_to(REPO).with_suffix('')
        parts = list(rel.parts)
        if parts[-1] == '__init__':
            parts = parts[:-1]
        mods.append('.'.join(parts))
    return mods


def test_port_imports_no_jax_and_no_jax_package():
    code = (
        'import importlib, sys\n'
        f'for m in {_port_modules() + ["chip_smoke"]!r}:\n'
        '    importlib.import_module(m)\n'
        'bad = sorted(m for m in sys.modules if m == "jax" or '
        'm.startswith(("jax.", "jaxlib", "flax", "skypilot_tpu.")) or '
        'm == "skypilot_tpu")\n'
        'assert not bad, bad\n'
        'print("ok", len(sys.modules))\n')
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith('ok')


@pytest.mark.parametrize('path', sorted(
    p.relative_to(REPO).as_posix()
    for p in list(PORT.rglob('*.py')) + [REPO / 'chip_smoke.py']))
def test_port_source_has_no_jax_imports(path):
    text = (REPO / path).read_text()
    assert not re.search(r'^\s*(import|from)\s+(jax|flax|jaxlib)\b', text,
                         re.M)
    assert 'skypilot_tpu.' not in text
    assert 'from skypilot_tpu ' not in text
    assert not re.search(r'^\s*import skypilot_tpu\b', text, re.M)


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)


def test_entry_points_need_cuda_or_explicit_cpu(monkeypatch):
    from skypilot_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    from skypilot_tpu_torch.models.llama import (LLAMA_CONFIGS, Llama,
                                                 init_params)
    cfg = LLAMA_CONFIGS['tiny']
    model = Llama(cfg, init_params(cfg, 'cpu'))
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        init_params(cfg)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        DecodeEngine(model, EngineConfig(n_slots=1))
    # Explicit CPU runs; a model on another device than the engine's is
    # refused rather than moved.
    engine = DecodeEngine(model, EngineConfig(n_slots=1,
                                              prefill_buckets=(8,)),
                          device='cpu')
    req = engine.submit([1, 2, 3], 3)
    for _ in range(20):
        if req.finished_at is not None:
            break
        engine.step()
    assert len(req.tokens()) == 3 and engine.device.type == 'cpu'
    with pytest.raises(ValueError, match='parameters are on'):
        DecodeEngine(model, EngineConfig(n_slots=1), device='meta')


def test_server_main_needs_cuda(monkeypatch):
    from skypilot_tpu_torch.inference import server
    _no_cuda(monkeypatch)
    monkeypatch.setattr(sys, 'argv', ['server', '--model', 'tiny'])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        server.main()


def _import_lines_dropped(text):
    return [line for line in text.splitlines()
            if not re.match(r'\s*(from|import)\s+skypilot_tpu', line)]


@pytest.mark.parametrize('rel', COPIED)
def test_copied_modules_match_originals(rel):
    original = (REPO / 'skypilot_tpu' / rel).read_text()
    copy = (PORT / rel).read_text()
    assert _import_lines_dropped(copy) == _import_lines_dropped(original)
    for line in copy.splitlines():
        if re.match(r'\s*(from|import)\s+skypilot_tpu', line):
            assert 'skypilot_tpu_torch' in line


def test_training_slice_modules_are_covered():
    """The isolation checks above walk every module of the port; the
    training slice's modules are among them."""
    mods = set(_port_modules())
    assert {'skypilot_tpu_torch.train.trainer',
            'skypilot_tpu_torch.train.checkpoint',
            'skypilot_tpu_torch.train.flops',
            'skypilot_tpu_torch.obs.goodput'} <= mods
    assert sorted(p.name for p in (PORT / 'csrc').glob('*.cu')) == [
        'flash_attention_bwd.cu', 'flash_attention_fwd.cu']
