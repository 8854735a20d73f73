"""Quick check and timing of the flash-attention kernels on one GPU.

    python -m skypilot_tpu_torch.ops.cuda.probe build  # nvcc, ptxas report
    python -m skypilot_tpu_torch.ops.cuda.probe check  # kernels vs plain
    python -m skypilot_tpu_torch.ops.cuda.probe check small  # D = 16, 32
    python -m skypilot_tpu_torch.ops.cuda.probe time   # CUDA-event times
    python -m skypilot_tpu_torch.ops.cuda.probe time dq  # only names with 'dq'

`check` holds the forward (out, lse) and the dk/dv and dq kernels against
their plain versions at shapes on the edges of the kernels' tiles, up to
bench-1b's training shape, then the small-head-dim forward (head_dim 16
and 32; no backward kernel takes them) at its tile edges; `check small`
runs only the latter; `time` times the forward, dq and dk/dv at
bench-1b's shape (B=4, Hq=16, Hkv=8, S=4096, D=128, causal bf16) and the
forward at the serving shape (B=8, H=32, S=256), each the mean of 20 calls
queued behind a spin kernel, so the device runs them back to back.  To
compare two versions of a kernel on one card, unpack each tree into a
directory of its own and run `time` from each in turns (A, B, B, A) in one
call; each tree builds its own library under its own `build/`.
`chip_smoke.py` is the full check; this is the short loop for kernel work.
"""
from __future__ import annotations

import sys

import torch

from skypilot_tpu_torch.ops.cuda import flash_attention as fa

CHECK_SHAPES = [  # (b, hq, hkv, s, d, causal, dtype)
    (1, 2, 2, 63, 128, True, torch.bfloat16),
    (1, 2, 2, 65, 128, False, torch.bfloat16),
    (1, 2, 2, 128, 128, True, torch.bfloat16),
    (1, 2, 2, 129, 64, True, torch.float16),
    (1, 8, 1, 255, 128, True, torch.bfloat16),
    (1, 2, 2, 128, 128, False, torch.bfloat16),
    (1, 2, 2, 32, 128, True, torch.bfloat16),
    (2, 8, 2, 96, 64, True, torch.float16),
    (1, 4, 2, 192, 128, True, torch.bfloat16),
    (1, 4, 2, 320, 128, False, torch.bfloat16),
    (2, 32, 8, 256, 64, True, torch.bfloat16),
    (1, 4, 2, 1024, 128, True, torch.bfloat16),
    (4, 16, 8, 4096, 128, True, torch.bfloat16),
]
# The small-head-dim forward: 64-row tiles, so S on both sides of 64 and
# 128; GQA groups 1, 2 and 4; the `tiny` probe's S = 8 and 16.
SMALL_CHECK_SHAPES = [
    (b, hq, hkv, s, d, causal, dtype)
    for b, hq, hkv in ((2, 4, 2),)
    for s in (1, 5, 8, 16, 17, 63, 64, 65, 127, 128, 129)
    for d in (16, 32)
    for causal in (True, False)
    for dtype in (torch.bfloat16, torch.float16)
] + [(1, 8, 2, 1024, 16, True, torch.bfloat16),
     (3, 4, 4, 300, 32, False, torch.float16)]
SPIN_CYCLES = 20_000_000


def _inputs(gen, b, hq, hkv, s, d, dtype):
    q, g = (torch.randn((b, hq, s, d), generator=gen,
                        device='cuda').to(dtype) for _ in range(2))
    k, v = (torch.randn((b, hkv, s, d), generator=gen,
                        device='cuda').to(dtype) for _ in range(2))
    return q, k, v, g


def _norm_rel(x, ref) -> float:
    return ((x.float() - ref.float()).norm() / ref.float().norm()).item()


def check_small() -> None:
    """The forward at head_dim 16 and 32 against its plain version."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    worst = 0.0
    for b, hq, hkv, s, d, causal, dtype in SMALL_CHECK_SHAPES:
        q, k, v, _ = _inputs(gen, b, hq, hkv, s, d, dtype)
        before = fa.flash_attention_fwd_small.launches
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                          return_residuals=True)
        no_lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_attention_fwd_reference(
            q, k, v, causal=causal, return_residuals=True)
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        worst = max(worst, err, lse_err)
        print(f'{(b, hq, hkv, s, d, causal, str(dtype)[6:])}: out max '
              f'{err:.3e} lse max {lse_err:.3e} no-lse equal '
              f'{bool(torch.equal(out, no_lse))} launches '
              f'{fa.flash_attention_fwd_small.launches - before}',
              flush=True)
    print(f'small forward worst max-abs {worst:.3e}', flush=True)


def check() -> None:
    gen = torch.Generator(device='cuda').manual_seed(0)
    for b, hq, hkv, s, d, causal, dtype in CHECK_SHAPES:
        q, k, v, g = _inputs(gen, b, hq, hkv, s, d, dtype)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                          return_residuals=True)
        delta = (g.float() * out.float()).sum(-1)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal)
        dq = fa.flash_attention_bwd_dq(q, k, v, g, lse, delta, causal)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_attention_fwd_reference(
            q, k, v, causal=causal, return_residuals=True)
        line = (f'{(b, hq, hkv, s, d, causal, str(dtype)[6:])}: out max '
                f'{(out.float() - ref.float()).abs().max().item():.3e} lse '
                f'max {(lse - ref_lse).abs().max().item():.3e}')
        del ref, ref_lse
        ref_dk, ref_dv = fa.flash_attention_bwd_dkv_reference(
            q, k, v, g, lse, delta, causal)
        line += (f' | norm-rel dk {_norm_rel(dk, ref_dk):.3e} dv '
                 f'{_norm_rel(dv, ref_dv):.3e}')
        del ref_dk, ref_dv
        ref_dq = fa.flash_attention_bwd_dq_reference(q, k, v, g, lse, delta,
                                                     causal)
        line += f' dq {_norm_rel(dq, ref_dq):.3e}'
        print(line, flush=True)
        del ref_dq
        torch.cuda.empty_cache()
    check_small()


def _time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_kernels(only: str = '') -> None:
    gen = torch.Generator(device='cuda').manual_seed(0)
    q, k, v, g = _inputs(gen, 4, 16, 8, 4096, 128, torch.bfloat16)
    out, lse = fa.flash_attention_fwd(q, k, v, return_residuals=True)
    delta = (g.float() * out.float()).sum(-1)
    calls = {
        'bench-1b fwd': lambda: fa.flash_attention_fwd(
            q, k, v, return_residuals=True),
        'bench-1b dkv': lambda: fa.flash_attention_bwd_dkv(
            q, k, v, g, lse, delta),
        'bench-1b dq': lambda: fa.flash_attention_bwd_dq(
            q, k, v, g, lse, delta),
    }
    for name, fn in calls.items():
        if only in name:
            print(f'{name} ms {_time_ms(fn):.4f}', flush=True)
    if only in 'serving fwd':
        qs, ks, vs, _ = _inputs(gen, 8, 32, 32, 256, 128, torch.bfloat16)
        print(f'serving fwd ms '
              f'{_time_ms(lambda: fa.flash_attention_fwd(qs, ks, vs)):.4f}')


def main(argv) -> int:
    mode = argv[1] if len(argv) > 1 else 'check'
    if mode == 'build':
        print(fa.build())
    elif mode == 'check':
        check_small() if argv[2:] == ['small'] else check()
    elif mode == 'time':
        time_kernels(argv[2] if len(argv) > 2 else '')
    else:
        print(__doc__)
        return 2
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv))
