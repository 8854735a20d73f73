"""Isolation and no-fallback rules of the PyTorch port (skypilot_tpu_torch):
it imports neither JAX nor the JAX package, its entry points refuse to
run without CUDA unless told to use the CPU, and its copies of the JAX
package's JAX-free modules stay verbatim apart from import lines."""
import ast
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
          'server/tracing.py', 'inference/paging.py',
          # The control-plane store the goodput ledger writes through, the
          # ledger itself, and the bucket helpers of the gs:// fetch.
          'state/__init__.py', 'state/dialect.py', 'state/sqlite.py',
          'state/postgres.py', 'state/leases.py', 'utils/db_utils.py',
          'sky_config.py', 'utils/common_utils.py', 'utils/schemas.py',
          'serve/metrics_math.py', 'obs/store.py', 'obs/goodput.py',
          'data/storage_utils.py']
# Every kernel source of the port (csrc/).
KERNEL_SOURCES = ['flash_attention_bwd_dkv.cu',
                  'flash_attention_bwd_dkv_small.cu',
                  'flash_attention_bwd_dq.cu',
                  'flash_attention_bwd_dq_small.cu',
                  'flash_attention_fwd.cu', 'flash_attention_fwd_small.cu',
                  'sm80_mma.cuh', 'sm90_common.cuh']


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
    assert sorted(p.name for p in (PORT / 'csrc').glob('*.cu*')) == (
        KERNEL_SOURCES)


def test_paged_serving_slice_modules_are_covered():
    """The isolation checks above walk every module of the port; the
    paged serving slice's modules are among them, and its wire-format
    module keeps the JAX package's constants."""
    mods = set(_port_modules())
    assert {'skypilot_tpu_torch.inference.paging',
            'skypilot_tpu_torch.inference.kv_quant',
            'skypilot_tpu_torch.inference.kv_transfer',
            'skypilot_tpu_torch.inference.engine',
            'skypilot_tpu_torch.inference.server'} <= mods
    text = (PORT / 'inference' / 'kv_transfer.py').read_text()
    for const in ("_MAGIC = b'SKVT1'", 'VERSION = 1',
                  "DECODE_URL_HEADER = 'X-Skytpu-Decode-Url'",
                  "ADOPT_ROUTE = '/v1/kv_adopt'"):
        assert const in text


def test_weights_and_rl_slice_modules_are_covered():
    """The isolation checks above walk every module of the port; the
    weights-lifecycle and RL slice's modules are among them."""
    mods = set(_port_modules())
    assert {'skypilot_tpu_torch.inference.weights',
            'skypilot_tpu_torch.train.rl',
            'skypilot_tpu_torch.train.checkpoint'} <= mods


def test_model_zoo_slice_modules_are_covered():
    """The isolation checks above walk every module of the port; the
    model zoo's modules are among them, and the package exports them."""
    mods = set(_port_modules())
    assert {'skypilot_tpu_torch.models.moe',
            'skypilot_tpu_torch.models.encoder',
            'skypilot_tpu_torch.models.resnet',
            'skypilot_tpu_torch.models.convert'} <= mods
    from skypilot_tpu_torch import models
    for name in ('MoEMLP', 'EncoderClassifier', 'ENCODER_CONFIGS',
                 'ResNet', 'RESNET_CONFIGS'):
        assert name in models.__all__ and hasattr(models, name)


def test_perf_slice_modules_are_covered():
    """The isolation checks above walk every module of the port; the perf
    plane's modules are among them, the package exports them, and the
    bandwidth table holds the card's entry and the nominal CPU one, no
    TPU chip."""
    mods = set(_port_modules())
    assert {'skypilot_tpu_torch.perf',
            'skypilot_tpu_torch.perf.cost_model',
            'skypilot_tpu_torch.perf.compile_telemetry',
            'skypilot_tpu_torch.perf.profiler'} <= mods
    from skypilot_tpu_torch import perf
    assert perf.__all__ == ['compile_telemetry', 'cost_model', 'profiler']
    assert perf.cost_model.HBM_GBPS == {'h100': 3350.0, 'cpu': 100.0}


# Names the port copies out of JAX modules (plain Python there), by file.
COPIED_NAMES = {
    'parallel/mesh.py': ['MESH_AXES', 'mesh_axes', 'MeshPlan', 'plan_mesh',
                         'validate_tensor_parallel', 'plan_serve_mesh'],
    'parallel/sharding.py': ['DEFAULT_RULES', 'rules_to_dict',
                             'logical_to_spec'],
    'parallel/distributed.py': ['ENV_NUM_NODES', 'ENV_NODE_RANK',
                                'ENV_NODE_IPS', 'ENV_COORDINATOR',
                                'ENV_NUM_SLICES', 'ENV_SLICE_ID',
                                'DEFAULT_COORDINATOR_PORT',
                                'distributed_env_from_cluster'],
    'exceptions.py': ['SkyTpuError', 'InvalidTaskError',
                      'InvalidSkyConfigError', 'InvalidRequestError',
                      'StorageError'],
    'perf/gate.py': ['TOLERANCES', 'GAUGE_AGREEMENT_FRAC', 'latest_bench',
                     '_dig', '_ratio_check', '_agreement_check', 'run',
                     'render_report'],
    'data/storage.py': ['_fake_root', '_BucketStore', 'GcsStore',
                        'fnmatch_to_re'],
    'inference/weights.py': ['_materialize_local', '_cleanup_fetched'],
}


def _top_level_sources(text):
    """{name: source} of a module's top-level defs, classes and
    assignments."""
    out = {}
    for node in ast.parse(text).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names = [node.name]
        elif isinstance(node, ast.Assign):
            names = [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign):
            names = [node.target.id]
        else:
            continue
        for name in names:
            out[name] = ast.get_source_segment(text, node)
    return out


@pytest.mark.parametrize('rel', sorted(COPIED_NAMES))
def test_copied_planners_and_rules_match_originals(rel):
    """The mesh planners, the sharding rules and the other copied names
    are the JAX package's, verbatim apart from import lines (which name
    the port)."""
    original = _top_level_sources((REPO / 'skypilot_tpu' / rel).read_text())
    copy = _top_level_sources((PORT / rel).read_text())
    for name in COPIED_NAMES[rel]:
        assert (_import_lines_dropped(copy[name]) ==
                _import_lines_dropped(original[name])), name
        for line in copy[name].splitlines():
            if re.match(r'\s*(from|import)\s+skypilot_tpu', line):
                assert 'skypilot_tpu_torch' in line, (name, line)


def test_tensor_parallel_slice_modules_are_covered():
    """The isolation checks above walk every module of the port; the
    tensor-parallel serving slice's modules are among them, the package
    exports the planners, and the kernel sources are the known set."""
    mods = set(_port_modules())
    assert {'skypilot_tpu_torch.parallel',
            'skypilot_tpu_torch.parallel.mesh',
            'skypilot_tpu_torch.parallel.sharding',
            'skypilot_tpu_torch.parallel.group'} <= mods
    from skypilot_tpu_torch import parallel
    for name in ('MeshPlan', 'build_mesh', 'build_serve_mesh', 'plan_mesh',
                 'plan_serve_mesh', 'validate_tensor_parallel'):
        assert name in parallel.__all__ and hasattr(parallel, name)
    assert sorted(p.name for p in (PORT / 'csrc').glob('*.cu*')) == (
        KERNEL_SOURCES)


def test_sharded_training_slice_modules_are_covered():
    """The isolation checks above walk every module of the port; the
    sharded training slice's modules are among them, the package exports
    them, the port has no copy of libtpu's MEGASCALE contract, and the
    kernel sources are the known set."""
    mods = set(_port_modules())
    assert {'skypilot_tpu_torch.parallel.distributed',
            'skypilot_tpu_torch.parallel.ring_attention'} <= mods
    from skypilot_tpu_torch import parallel
    from skypilot_tpu_torch.parallel import ring_attention
    for name in ('maybe_initialize_distributed', 'LocalRanks',
                 'distributed_env_from_cluster'):
        assert name in parallel.__all__ and hasattr(parallel, name)
    assert callable(ring_attention.ring_attention)
    assert callable(ring_attention.ring_attention_reference)
    text = (PORT / 'parallel' / 'distributed.py').read_text()
    assert 'def megascale_env_from_cluster' not in text
    assert sorted(p.name for p in (PORT / 'csrc').glob('*.cu*')) == (
        KERNEL_SOURCES)


def test_pipeline_expert_and_graft_slice_modules_are_covered():
    """The isolation checks above walk every module of the port; the
    pipeline / expert-parallel / validation slice's modules and the graft
    entry's twin are among them, the package exports the new names, the
    device table holds the card's entry and no TPU, and the kernel
    sources are the known set."""
    mods = set(_port_modules())
    assert {'skypilot_tpu_torch.parallel.pipeline',
            'skypilot_tpu_torch.parallel.validate',
            'skypilot_tpu_torch.exceptions',
            'skypilot_tpu_torch.graft_entry'} <= mods
    from skypilot_tpu_torch import parallel
    for name in ('pipeline_apply', 'stack_stage_params',
                 'stage_param_sharding', 'validate_placement',
                 'PlacementReport'):
        assert name in parallel.__all__ and hasattr(parallel, name)
    assert sorted(parallel.validate.DEVICES) == ['h100']
    text = (PORT / 'models' / 'moe.py').read_text()
    assert 'Left out' not in text
    assert sorted(p.name for p in (PORT / 'csrc').glob('*.cu*')) == (
        KERNEL_SOURCES)


def test_gate_ledger_and_storage_slice_modules_are_covered():
    """The isolation checks above walk every module of the port; the perf
    gate, the goodput ledger with the control-plane store under it, and
    the gs:// fetch are among them, and the small-head-dim forward kernel
    is a source of its own with its own C entry."""
    mods = set(_port_modules())
    assert {'skypilot_tpu_torch.perf.gate',
            'skypilot_tpu_torch.obs.goodput',
            'skypilot_tpu_torch.obs.store',
            'skypilot_tpu_torch.state',
            'skypilot_tpu_torch.state.dialect',
            'skypilot_tpu_torch.state.sqlite',
            'skypilot_tpu_torch.state.postgres',
            'skypilot_tpu_torch.state.leases',
            'skypilot_tpu_torch.utils.db_utils',
            'skypilot_tpu_torch.utils.common_utils',
            'skypilot_tpu_torch.utils.schemas',
            'skypilot_tpu_torch.sky_config',
            'skypilot_tpu_torch.serve.metrics_math',
            'skypilot_tpu_torch.data.storage',
            'skypilot_tpu_torch.data.storage_utils'} <= mods
    from skypilot_tpu_torch.obs import goodput
    from skypilot_tpu_torch.perf import gate
    assert callable(goodput.GoodputLedger) and callable(gate.main)
    for name in ('step_time_skew', 'evaluate_stragglers', 'train_obs_tick',
                 'jobs_dsn'):
        assert callable(getattr(goodput, name)), name
    # The small-head-dim kernels (the forward, then dq and dk/dv) are
    # mma.sync + cp.async kernels on the helpers of csrc/sm80_mma.cuh.
    helpers = (PORT / 'csrc' / 'sm80_mma.cuh').read_text()
    assert 'mma.sync.aligned.m16n8k16' in helpers and 'cp.async' in helpers
    for kernel in ('fwd', 'bwd_dq', 'bwd_dkv'):
        src = (PORT / 'csrc' /
               f'flash_attention_{kernel}_small.cu').read_text()
        assert f'extern "C" int skytpu_flash_attention_{kernel}_small(' in src
        assert '#include "sm80_mma.cuh"' in src and 'sm80::mma16816' in src
