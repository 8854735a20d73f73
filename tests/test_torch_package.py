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
          'state/__init__.py', 'state/dialect.py',
          'state/postgres.py', 'state/leases.py', 'utils/db_utils.py',
          'sky_config.py', 'utils/common_utils.py', 'utils/schemas.py',
          'serve/metrics_math.py', 'obs/store.py', 'obs/goodput.py',
          'data/storage_utils.py',
          # The launch path: types, policy and identity, planning, state,
          # provisioning, runners, the head agent and the driver.
          'exceptions.py', 'accelerators.py', 'utils/infra_utils.py',
          'utils/ux_utils.py', 'resources.py', 'dag.py', 'admin_policy.py',
          'users.py', 'workspaces.py', 'usage_lib.py', 'clouds/cloud.py',
          'clouds/local.py', 'catalog/__init__.py', 'catalog/gcp_catalog.py',
          'optimizer.py', 'global_user_state.py', 'provision/common.py',
          'provision/failover.py', 'provision/local/__init__.py',
          'provision/local/instance.py', 'utils/command_runner.py',
          'utils/locks.py', 'agent/__init__.py', 'agent/job_queue.py',
          'agent/autostop.py', 'agent/events.py', 'logs/__init__.py',
          'backends/__init__.py', 'backends/backend.py',
          'backends/backend_utils.py', 'execution.py', 'core.py',
          # Managed jobs, their terminal views, and SkyServe.
          'jobs/__init__.py', 'jobs/state.py', 'jobs/recovery_strategy.py',
          'jobs/controller.py', 'jobs/core.py', 'obs/top.py',
          'obs/jobs_top.py', 'serve/__init__.py', 'serve/service_spec.py',
          'serve/serve_state.py', 'serve/spot_placer.py',
          'serve/load_balancing_policies.py', 'serve/autoscalers.py',
          'serve/load_balancer.py', 'serve/replica_managers.py',
          'serve/controller.py', 'serve/core.py', 'serve/slo_sim.py',
          # The REST API server, its request store, auth and daemons, and
          # the client package with the async SDK.
          'server/constants.py', 'server/payloads.py',
          'server/requests_db.py', 'utils/auth.py', 'metrics_utils.py',
          'server/handlers.py', 'server/executor.py', 'server/daemons.py',
          'client/__init__.py', 'client/sdk_async.py',
          # The other clouds with their provisioners, SDK adaptors and
          # catalogs, the SSH keys and node pools, bucket storage, and
          # the volumes their provisioners back.
          'clouds/__init__.py', 'clouds/gcp.py', 'clouds/aws.py',
          'clouds/kubernetes.py', 'clouds/slurm.py', 'clouds/ssh.py',
          'adaptors/__init__.py', 'adaptors/gcp.py', 'adaptors/aws.py',
          'provision/gcp/__init__.py', 'provision/gcp/tpu_client.py',
          'provision/gcp/gce_client.py', 'provision/gcp/instance.py',
          'provision/aws/__init__.py', 'provision/aws/ec2_client.py',
          'provision/aws/instance.py', 'provision/kubernetes/__init__.py',
          'provision/kubernetes/instance.py', 'provision/slurm/__init__.py',
          'provision/slurm/instance.py', 'provision/ssh/__init__.py',
          'provision/ssh/instance.py', 'catalog/aws_catalog.py',
          'catalog/data_fetchers/__init__.py', 'authentication.py',
          'ssh_node_pools.py', 'data/__init__.py', 'data/storage.py',
          'volumes.py',
          # The fleet simulator and the goodput sim, and the cross-cloud
          # bucket transfer.
          'fleetsim/traffic.py', 'fleetsim/scenario.py',
          'fleetsim/profile.py', 'fleetsim/sim.py',
          'fleetsim/goodput_run.py', 'data/transfer.py']
# Modules whose code is the original's with the package renamed (import
# lines and the constants that name the package), docstrings aside: the
# analyzer's modules copied from skypilot_tpu/analysis/ (their docstrings
# name the port's gate), the SLO alert rules, whose AlertRule the
# metric-naming rule of the port's analyzer holds to the registry, and
# the launch path's modules whose strings name the package (the task's
# comment, the catalog's refresh hint, the provisioners' module path),
# and the dedicated-controller mode's, whose commands name the module
# they run on the controller host; the API server's app and the SDK,
# whose commands name the server module they start; the GCP catalog
# fetcher, whose usage line names its module; the fleet simulator's
# package and CLI, which name the module a user runs.
COPIED_CODE = ['obs/alerts.py', 'analysis/core.py', 'analysis/reporters.py',
               'analysis/rules/blocking_async.py',
               'analysis/rules/db_discipline.py',
               'analysis/rules/metric_naming.py',
               'analysis/rules/unbounded_io.py',
               'task.py', 'catalog/common.py', 'provision/__init__.py',
               'controller_vm.py', 'jobs/remote_exec.py',
               'jobs/controller_daemon.py', 'server/app.py', 'client/sdk.py',
               'catalog/data_fetchers/fetch_gcp.py', 'fleetsim/__init__.py',
               'fleetsim/__main__.py']
# The port's deliberate rewrites, each a counterpart whose docstring names
# its twin and says how it differs: the launch path's
# (tests/test_torch_launch.py and test_torch_control_plane.py hold their
# behaviour), the API server slice's: the package docstring and the CLI
# over the port's modules (tests/test_torch_api_server.py), the sqlite
# store whose WAL switch survives a concurrent open
# (tests/test_torch_sqlite.py), the Docker runtime that hands a GPU task
# the cards (tests/test_torch_docker.py), the agent client that waits
# for its SSH tunnel to open (tests/test_torch_ssh.py), and the fuse proxy
# that builds into the port's own build tree
# (tests/test_torch_fuse_proxy.py).
COUNTERPARTS = ['agent/gang.py', 'agent/server.py', 'agent/client.py',
                'backends/tpu_vm_backend.py', 'server/__init__.py',
                'client/cli.py', 'state/sqlite.py',
                'provision/docker_utils.py', 'data/fuse_proxy.py']
# Every kernel source of the port (csrc/).
KERNEL_SOURCES = ['flash_attention_bwd_dkv.cu',
                  'flash_attention_bwd_dkv_256.cu',
                  'flash_attention_bwd_dkv_f32.cu',
                  'flash_attention_bwd_dkv_f32_wide.cu',
                  'flash_attention_bwd_dkv_mma.cuh',
                  'flash_attention_bwd_dkv_small.cu',
                  'flash_attention_bwd_dkv_wide.cu',
                  'flash_attention_bwd_dq.cu',
                  'flash_attention_bwd_dq_256.cu',
                  'flash_attention_bwd_dq_f32.cu',
                  'flash_attention_bwd_dq_f32_wide.cu',
                  'flash_attention_bwd_dq_mma.cuh',
                  'flash_attention_bwd_dq_small.cu',
                  'flash_attention_bwd_dq_wide.cu',
                  'flash_attention_fwd.cu', 'flash_attention_fwd_256.cu',
                  'flash_attention_fwd_f32.cu',
                  'flash_attention_fwd_f32_wide.cu',
                  'flash_attention_fwd_mma.cuh',
                  'flash_attention_fwd_small.cu',
                  'flash_attention_fwd_wide.cu',
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
    # mma.sync + cp.async kernels on the helpers of csrc/sm80_mma.cuh:
    # one template each (flash_attention_{kernel}_mma.cuh), instantiated
    # at head_dim 16/32 in its `_small` source and at 80/96 in its `_wide`
    # source, each with its own C entry; all three at 256 in bf16/fp16 are
    # wgmma kernels of their own (`_256` source, on
    # csrc/sm90_common.cuh).  The templates' products go
    # through sm80::mma: m16n8k16 for bf16/fp16, m16n8k8 tf32 three times
    # (3xTF32) for f32, whose C entry (`_f32` source, 16/32/64/128)
    # reaches 80/96/256 in its `_f32_wide` source.
    helpers = (PORT / 'csrc' / 'sm80_mma.cuh').read_text()
    assert 'mma.sync.aligned.m16n8k16' in helpers and 'cp.async' in helpers
    assert 'mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32' in helpers
    assert 'cvt.rna.tf32.f32' in helpers
    for kernel in ('fwd', 'bwd_dq', 'bwd_dkv'):
        template = (PORT / 'csrc' /
                    f'flash_attention_{kernel}_mma.cuh').read_text()
        assert '#include "sm80_mma.cuh"' in template
        assert 'sm80::mma(' in template
        src = (PORT / 'csrc' / f'flash_attention_{kernel}_f32.cu').read_text()
        wide = (PORT / 'csrc' /
                f'flash_attention_{kernel}_f32_wide.cu').read_text()
        assert f'extern "C" int skytpu_flash_attention_{kernel}_f32(' in src
        for width, text in ((16, src), (32, src), (64, src), (128, src),
                            (80, wide), (96, wide), (256, wide)):
            assert f'<float, {width}>(' in text, (kernel, width)
        for suffix, widths in (('small', (16, 32)), ('wide', (80, 96))):
            src = (PORT / 'csrc' /
                   f'flash_attention_{kernel}_{suffix}.cu').read_text()
            assert (f'extern "C" int skytpu_flash_attention_{kernel}_'
                    f'{suffix}(') in src
            assert f'#include "flash_attention_{kernel}_mma.cuh"' in src
            for width in widths:
                assert f'<{width}>(' in src, (kernel, suffix, width)
            assert '<256>(' not in src, (kernel, suffix)
        src = (PORT / 'csrc' / f'flash_attention_{kernel}_256.cu').read_text()
        assert f'extern "C" int skytpu_flash_attention_{kernel}_256(' in src
        assert '#include "sm90_common.cuh"' in src
        assert 'sm90::wgmma_ss<' in src and 'sm90::wgmma_rs<' in src


def _code_without_docstrings(text):
    """The module's AST without its docstrings (comments and layout are
    not in it), dumped for comparison."""
    tree = ast.parse(text)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body and \
                isinstance(node.body[0], ast.Expr) and \
                isinstance(node.body[0].value, ast.Constant) and \
                isinstance(node.body[0].value.value, str):
            node.body = node.body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize('rel', COPIED_CODE)
def test_copied_analysis_modules_match_originals(rel):
    """The alert rules, and the analyzer's framework, reporters and the
    four rules that know no JAX, are the JAX package's code with
    `skypilot_tpu_torch` where it names `skypilot_tpu`, and nothing
    else."""
    original = (REPO / 'skypilot_tpu' / rel).read_text()
    copy = (PORT / rel).read_text()
    assert 'skypilot_tpu_torch' in copy
    assert _code_without_docstrings(
        copy.replace('skypilot_tpu_torch', 'skypilot_tpu')) == (
        _code_without_docstrings(original))


def test_analysis_slice_modules_are_covered():
    """The isolation checks above walk every module of the port; the
    analyzer's modules and the alert rules are among them, the package
    keeps the JAX analyzer's public names and rule set, and the kernel
    sources are the known set (this slice adds no kernel)."""
    mods = set(_port_modules())
    assert {'skypilot_tpu_torch.analysis',
            'skypilot_tpu_torch.analysis.__main__',
            'skypilot_tpu_torch.analysis.core',
            'skypilot_tpu_torch.analysis.callgraph',
            'skypilot_tpu_torch.analysis.reporters',
            'skypilot_tpu_torch.analysis.rules',
            'skypilot_tpu_torch.analysis.rules.hot_loop_sync',
            'skypilot_tpu_torch.analysis.rules.recompile_hazard',
            'skypilot_tpu_torch.analysis.rules.speculation',
            'skypilot_tpu_torch.analysis.rules.blocking_async',
            'skypilot_tpu_torch.analysis.rules.db_discipline',
            'skypilot_tpu_torch.analysis.rules.metric_naming',
            'skypilot_tpu_torch.analysis.rules.unbounded_io',
            'skypilot_tpu_torch.obs.alerts'} <= mods
    from skypilot_tpu_torch import analysis
    from skypilot_tpu_torch.analysis.rules import all_rules
    assert analysis.__all__ == ['Finding', 'Project', 'Report', 'Rule',
                                'load_project', 'run_check', 'render_json',
                                'render_text']
    assert [(r.name, r.suppress_token) for r in all_rules()] == [
        ('hot-loop-sync', 'sync'), ('recompile-hazard', 'recompile'),
        ('blocking-in-async', 'blocking'), ('db-discipline', 'db'),
        ('unbounded-io', 'unbounded-io'), ('metric-naming', 'metric-naming'),
        ('speculation', 'spec')]
    assert sorted(p.name for p in (PORT / 'csrc').glob('*.cu*')) == (
        KERNEL_SOURCES)


def assert_covered(rels):
    """Each of `rels` (paths under the package) is pinned (COPIED,
    COPIED_CODE) or one of COUNTERPARTS, not both; a counterpart's twin
    exists in the JAX package and its docstring names it."""
    pinned = set(COPIED) | set(COPIED_CODE)
    for rel in rels:
        assert (rel in pinned) != (rel in COUNTERPARTS), rel
        if rel in COUNTERPARTS:
            assert (REPO / 'skypilot_tpu' / rel).exists(), rel
            doc = ast.get_docstring(ast.parse((PORT / rel).read_text()))
            assert f'counterpart of `skypilot_tpu/{rel}`' in ' '.join(
                doc.lower().split()), rel


def test_launch_slice_modules_are_covered():
    """The isolation checks above walk every module of the port; the
    launch path's modules are among them, each is pinned (COPIED,
    COPIED_CODE) or a counterpart that names its twin, the catalog's data
    files are the JAX package's byte for byte, and the kernel sources are
    the known set (this slice adds no kernel)."""
    mods = set(_port_modules())
    assert {'skypilot_tpu_torch.execution', 'skypilot_tpu_torch.core',
            'skypilot_tpu_torch.task', 'skypilot_tpu_torch.resources',
            'skypilot_tpu_torch.dag', 'skypilot_tpu_torch.optimizer',
            'skypilot_tpu_torch.clouds', 'skypilot_tpu_torch.catalog',
            'skypilot_tpu_torch.global_user_state',
            'skypilot_tpu_torch.provision',
            'skypilot_tpu_torch.provision.local.instance',
            'skypilot_tpu_torch.agent.gang',
            'skypilot_tpu_torch.agent.server',
            'skypilot_tpu_torch.backends',
            'skypilot_tpu_torch.backends.tpu_vm_backend'} <= mods
    launch = [p.relative_to(PORT).as_posix() for sub in (
        'agent', 'backends', 'catalog', 'clouds', 'logs', 'provision')
        for p in (PORT / sub).rglob('*.py')]
    assert_covered(launch)
    data = sorted(p.name for p in (PORT / 'catalog' / 'data').iterdir())
    assert data == sorted(
        p.name for p in (REPO / 'skypilot_tpu' / 'catalog' / 'data').iterdir())
    for name in data:
        assert ((PORT / 'catalog' / 'data' / name).read_bytes() ==
                (REPO / 'skypilot_tpu' / 'catalog' / 'data' / name)
                .read_bytes()), name
    from skypilot_tpu_torch import clouds
    assert sorted(clouds.CLOUD_REGISTRY) == ['aws', 'gcp', 'kubernetes',
                                             'local', 'slurm', 'ssh']
    assert sorted(p.name for p in (PORT / 'csrc').glob('*.cu*')) == (
        KERNEL_SOURCES)


def test_head_agent_imports_neither_torch_nor_jax():
    """The head agent's modules, and what its scheduler and event loop
    import while they run jobs, import neither torch nor JAX: the agent
    never touches a card and starts without paying either import."""
    code = (
        'import sys\n'
        'import skypilot_tpu_torch.agent.server\n'
        'import skypilot_tpu_torch.agent.events\n'
        'import skypilot_tpu_torch.logs\n'
        'import skypilot_tpu_torch.provision.local.instance\n'
        'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
        '("torch", "jax", "jaxlib", "flax", "skypilot_tpu"))\n'
        'assert not bad, bad\n'
        'print("ok")\n')
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == 'ok'


def test_jobs_and_serve_slice_modules_are_covered():
    """The isolation checks above walk every module of the port; managed
    jobs, SkyServe, the controller VM and the jobs views are among them,
    every one of them is pinned (COPIED or COPIED_CODE), the module each
    controller host runs is the port's, and the kernel sources are the
    known set (this slice adds no kernel)."""
    mods = set(_port_modules())
    assert {'skypilot_tpu_torch.jobs', 'skypilot_tpu_torch.jobs.controller',
            'skypilot_tpu_torch.jobs.controller_daemon',
            'skypilot_tpu_torch.jobs.remote_exec',
            'skypilot_tpu_torch.serve', 'skypilot_tpu_torch.serve.controller',
            'skypilot_tpu_torch.serve.load_balancer',
            'skypilot_tpu_torch.controller_vm',
            'skypilot_tpu_torch.obs.top',
            'skypilot_tpu_torch.obs.jobs_top'} <= mods
    ported = [p.relative_to(PORT).as_posix() for sub in ('jobs', 'serve')
              for p in (PORT / sub).rglob('*.py')]
    ported += ['controller_vm.py', 'obs/top.py', 'obs/jobs_top.py']
    pinned = set(COPIED) | set(COPIED_CODE)
    for rel in ported:
        assert rel in pinned, rel
    # Every module of the JAX package's jobs/ and serve/ has its copy.
    assert sorted(ported[:-3]) == sorted(
        p.relative_to(REPO / 'skypilot_tpu').as_posix()
        for sub in ('jobs', 'serve')
        for p in (REPO / 'skypilot_tpu' / sub).rglob('*.py'))
    for rel in ('controller_vm.py', 'jobs/remote_exec.py'):
        text = (PORT / rel).read_text()
        assert '-m skypilot_tpu_torch.jobs.' in text or (
            "'-m', 'skypilot_tpu_torch.jobs.controller_daemon'" in text), rel
    assert sorted(p.name for p in (PORT / 'csrc').glob('*.cu*')) == (
        KERNEL_SOURCES)


def test_jobs_serve_and_views_import_neither_torch_nor_jax():
    """Managed jobs, SkyServe (controller, load balancer, replica
    manager), the controller VM and `jobs top` import neither torch nor
    JAX: their controllers poll and proxy, and never touch a card."""
    code = (
        'import sys\n'
        'import skypilot_tpu_torch.jobs\n'
        'import skypilot_tpu_torch.jobs.controller_daemon\n'
        'import skypilot_tpu_torch.jobs.remote_exec\n'
        'import skypilot_tpu_torch.serve\n'
        'import skypilot_tpu_torch.serve.slo_sim\n'
        'import skypilot_tpu_torch.controller_vm\n'
        'import skypilot_tpu_torch.obs.jobs_top\n'
        'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
        '("torch", "jax", "jaxlib", "flax", "skypilot_tpu"))\n'
        'assert not bad, bad\n'
        'print("ok")\n')
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == 'ok'


def test_api_server_slice_modules_are_covered():
    """Every module of the JAX package's server/ and client/ has its
    port path, pinned (COPIED, COPIED_CODE) or a counterpart that names
    its twin; so do the modules they import (utils/auth.py, volumes.py,
    metrics_utils.py); the dashboard is the JAX package's byte for byte;
    and the kernel sources are the known set (this slice adds no
    kernel)."""
    jax_side = sorted(
        p.relative_to(REPO / 'skypilot_tpu').as_posix()
        for sub in ('server', 'client')
        for p in (REPO / 'skypilot_tpu' / sub).glob('*.py'))
    port_side = sorted(
        p.relative_to(PORT).as_posix()
        for sub in ('server', 'client') for p in (PORT / sub).glob('*.py'))
    assert port_side == jax_side
    assert_covered(jax_side + ['utils/auth.py', 'volumes.py',
                               'metrics_utils.py'])
    html = 'server/static/dashboard.html'
    assert (PORT / html).read_bytes() == (
        REPO / 'skypilot_tpu' / html).read_bytes()
    text = (REPO / 'pyproject.toml').read_text()
    assert ('skytpu-torch = "skypilot_tpu_torch.client.cli:main"' in text)
    assert '"skypilot_tpu_torch.server" = ["static/*.html"]' in text
    # The SDK auto-starts the port's server, from the port's checkout.
    sdk_text = (PORT / 'client' / 'sdk.py').read_text()
    assert "'-m', 'skypilot_tpu_torch.server.app'" in sdk_text
    assert sorted(p.name for p in (PORT / 'csrc').glob('*.cu*')) == (
        KERNEL_SOURCES)


def test_api_server_and_cli_import_neither_torch_nor_jax():
    """The server (and through it every handler a LONG request's worker
    runs), the CLI and the async SDK import neither torch nor JAX: a
    request worker starts without paying either import."""
    code = (
        'import sys\n'
        'import skypilot_tpu_torch.server.app, skypilot_tpu_torch.client.cli\n'
        'import skypilot_tpu_torch.client.sdk_async\n'
        'import skypilot_tpu_torch.server.daemons, skypilot_tpu_torch.volumes\n'
        'from skypilot_tpu_torch.server import handlers\n'
        'from skypilot_tpu_torch import execution, core, jobs, serve\n'
        'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
        '("torch", "jax", "jaxlib", "flax", "skypilot_tpu"))\n'
        'assert not bad, bad\n'
        'print("ok")\n')
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == 'ok'


# The other clouds, their provisioners, adaptors and catalogs, the Docker
# runtime, the SSH keys and node pools.
CLOUD_SLICE = [
    'provision/docker_utils.py', 'clouds/gcp.py', 'clouds/aws.py',
    'clouds/kubernetes.py', 'clouds/slurm.py', 'clouds/ssh.py',
    'provision/gcp/__init__.py', 'provision/gcp/tpu_client.py',
    'provision/gcp/gce_client.py', 'provision/gcp/instance.py',
    'provision/aws/__init__.py', 'provision/aws/ec2_client.py',
    'provision/aws/instance.py', 'provision/kubernetes/__init__.py',
    'provision/kubernetes/instance.py', 'provision/slurm/__init__.py',
    'provision/slurm/instance.py', 'provision/ssh/__init__.py',
    'provision/ssh/instance.py', 'adaptors/__init__.py', 'adaptors/gcp.py',
    'adaptors/aws.py', 'catalog/aws_catalog.py',
    'catalog/data_fetchers/__init__.py',
    'catalog/data_fetchers/fetch_gcp.py', 'authentication.py',
    'ssh_node_pools.py']


def test_clouds_slice_modules_are_covered():
    """The 27 module paths of the other clouds are in the port, each
    pinned or a counterpart that names its twin, as are the modules this
    slice turned back into copies (the registry, bucket storage, volumes)
    and the sqlite store it repaired; the JAX package's paths the port
    lacks are only the Pallas kernels (replaced by ops/cuda/); no module
    of the port refers a reader to the queue item this slice closed; the
    kernel sources are the known set (this slice adds no kernel)."""
    assert len(CLOUD_SLICE) == 27
    assert_covered(CLOUD_SLICE + ['clouds/__init__.py', 'data/storage.py',
                                  'data/__init__.py', 'volumes.py',
                                  'state/sqlite.py'])
    for rel in ('clouds/__init__.py', 'data/storage.py', 'volumes.py'):
        assert rel in COPIED, rel
    jax_side = {p.relative_to(REPO / 'skypilot_tpu').as_posix()
                for p in (REPO / 'skypilot_tpu').rglob('*.py')}
    port_side = {p.relative_to(PORT).as_posix() for p in PORT.rglob('*.py')}
    assert sorted(jax_side - port_side) == [
        'ops/pallas/__init__.py', 'ops/pallas/flash_attention.py']
    for path in sorted(PORT.rglob('*.py')):
        text = ' '.join(path.read_text().split())
        assert 'Queue 1 item 2' not in text, path
    assert sorted(p.name for p in (PORT / 'csrc').glob('*.cu*')) == (
        KERNEL_SOURCES)


def test_clouds_and_provisioners_import_neither_torch_nor_jax():
    """Every cloud, provisioner, adaptor, the Docker runtime, the key and
    pool modules and bucket storage import neither torch nor JAX (the
    head agent and a request worker reach them), and leave the provider
    SDKs (google-auth, boto3) unimported until first use."""
    mods = ', '.join(f'skypilot_tpu_torch.{rel[:-3].replace("/", ".")}'
                     .replace('.__init__', '')
                     for rel in CLOUD_SLICE + ['data/storage.py'])
    code = (
        'import sys\n'
        f'import {mods}\n'
        'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
        '("torch", "jax", "jaxlib", "flax", "skypilot_tpu", "boto3", '
        '"botocore") or m.startswith("google.auth"))\n'
        'assert not bad, bad\n'
        'print("ok")\n')
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == 'ok'


# The fleet simulator, the goodput sim, the transfer and the fuse proxy.
LAST_SLICE = [f'fleetsim/{m}.py' for m in ('__init__', '__main__',
                                           'goodput_run', 'profile',
                                           'scenario', 'sim', 'traffic')] + [
    'data/transfer.py', 'data/fuse_proxy.py']


def test_last_slice_modules_are_covered():
    """The port has every module path of the JAX package but the two
    Pallas modules that ops/cuda/ replaces; the last slice's nine paths
    are each pinned or a counterpart that names its twin; the kernel
    sources are the known set (this slice adds no kernel)."""
    assert len(LAST_SLICE) == 9
    assert_covered(LAST_SLICE)
    jax_side = {p.relative_to(REPO / 'skypilot_tpu').as_posix()
                for p in (REPO / 'skypilot_tpu').rglob('*.py')}
    port_side = {p.relative_to(PORT).as_posix() for p in PORT.rglob('*.py')}
    assert jax_side - port_side == {'ops/pallas/__init__.py',
                                    'ops/pallas/flash_attention.py'}
    assert sorted(p.name for p in (PORT / 'csrc').glob('*.cu*')) == (
        KERNEL_SOURCES)


def test_kernel_sources_are_package_data():
    """An installed port carries its kernel sources: every file under
    skypilot_tpu_torch/csrc/ matches a package-data pattern of
    pyproject.toml, so a wheel built from the tree holds them, and the
    library's build finds them beside the installed package."""
    tomllib = pytest.importorskip(
        'tomllib', reason='tomllib is in the standard library from 3.11')
    data = tomllib.loads((REPO / 'pyproject.toml').read_text())
    setuptools = data['tool']['setuptools']
    assert any(pathlib.PurePath('skypilot_tpu_torch').match(pattern)
               for pattern in setuptools['packages']['find']['include'])
    patterns = setuptools['package-data']['skypilot_tpu_torch']
    files = sorted(p.relative_to(PORT) for p in (PORT / 'csrc').iterdir())
    assert [p.name for p in files] == KERNEL_SOURCES
    for rel in files:
        assert any(rel.match(pattern) for pattern in patterns), rel


def test_last_slice_imports_neither_torch_nor_jax():
    """The fleet simulator (its CLI too), the goodput sim, the transfer
    and the fuse proxy import neither torch nor JAX: they run on any host
    beside the head agent, a request worker and the load balancer."""
    mods = ', '.join(f'skypilot_tpu_torch.{rel[:-3].replace("/", ".")}'
                     .replace('.__init__', '') for rel in LAST_SLICE)
    code = (
        'import sys\n'
        f'import {mods}\n'
        'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
        '("torch", "jax", "jaxlib", "flax", "skypilot_tpu"))\n'
        'assert not bad, bad\n'
        'print("ok")\n')
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == 'ok'
