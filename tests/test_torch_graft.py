"""The port's graft entry (skypilot_tpu_torch/graft_entry.py), the twin of
`__graft_entry__.py`: `dryrun_multichip(8)` runs every parallel path of
the JAX dry run on 8 CPU gloo ranks (the dcn x fsdp x tensor train
step, the ring, the MoE step at expert=4, tensor=2 serving with its
kv-head shard, the pipeline against the sequential fold) within 120 s,
under the rank-pool lock of tests/torch_rank_lock.py and at niceness +10
(a python of its own: its child and ranks inherit it); `entry()` gives
the llama-250m forward and its example arguments, and runs on the GPU
unless asked for the CPU."""
import os
import subprocess
import sys
import time

import pytest
import torch
import torch_rank_lock

from skypilot_tpu_torch import graft_entry

DRYRUN_LIMIT_S = 120.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_multichip_runs_every_parallel_path():
    with torch_rank_lock.hold(__name__):
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, '-c', 'from skypilot_tpu_torch.graft_entry '
             'import dryrun_multichip; dryrun_multichip(8)'],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
            preexec_fn=lambda: os.nice(10), capture_output=True, text=True,
            timeout=2 * DRYRUN_LIMIT_S)
        wall = time.monotonic() - t0
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = proc.stdout
    line = [x for x in out.splitlines()
            if x.startswith('dryrun_multichip ok')]
    assert line, out
    for part in ('mesh=MeshPlan(data=1, fsdp=2, tensor=2, expert=1, '
                 'pipeline=1, dcn=2)', 'ring_attention out=(2, 2, 16, 64)',
                 'experts a rank (1, 64, 128)', 'n_out=4',
                 'pipeline stages=4 ok'):
        assert part in line[0], (part, line[0])
    assert wall < DRYRUN_LIMIT_S, wall


def test_entry_is_the_llama_250m_forward(monkeypatch):
    from skypilot_tpu_torch.models.llama import LLAMA_CONFIGS
    cfg = LLAMA_CONFIGS['llama-250m']
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        graft_entry.entry()
    fn, (params, tokens) = graft_entry.entry('cpu')
    assert tuple(tokens.shape) == (1, 512)
    assert sum(p.numel() for p in params.values()) == cfg.num_params()
    logits = fn(params, tokens[:, :16])
    assert tuple(logits.shape) == (1, 16, cfg.vocab_size)
    assert torch.isfinite(logits).all()
