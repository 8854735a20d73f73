"""Quick check and timing of the flash-attention kernels on one GPU.

    python -m skypilot_tpu_torch.ops.cuda.probe build  # nvcc, ptxas report
    python -m skypilot_tpu_torch.ops.cuda.probe build DIR  # fresh, timed
    python -m skypilot_tpu_torch.ops.cuda.probe check  # kernels vs plain
    python -m skypilot_tpu_torch.ops.cuda.probe check small  # D = 16, 32
    python -m skypilot_tpu_torch.ops.cuda.probe check wide  # D 80/96/256,
                                                            # padded D
    python -m skypilot_tpu_torch.ops.cuda.probe check f32  # the f32 route
    python -m skypilot_tpu_torch.ops.cuda.probe check 256  # the three at 256
    python -m skypilot_tpu_torch.ops.cuda.probe time   # CUDA-event times
    python -m skypilot_tpu_torch.ops.cuda.probe time dq  # only names with 'dq'
    python -m skypilot_tpu_torch.ops.cuda.probe time 256  # the three at 256

`build DIR` compiles the sources of the csrc directory DIR afresh into a
temporary directory (nvcc's processes in parallel, as the library's build)
and prints the seconds, the way to compare two trees' build times.
`check` holds the forward (out, lse) and the dk/dv and dq kernels against
their plain versions at shapes on the edges of the kernels' tiles, up to
bench-1b's training shape, then the small-head-dim kernels (head_dim 16
and 32: forward, dq and dk/dv) at their tile edges, then the wide ones
(head_dim 80, 96, 256) and the zero-padded route (head_dims that no
kernel takes), then the f32 kernels (3xTF32) under their own f32-class
gates (F32_OUT_TOL, F32_NORM_RTOL) against plain versions in full f32
(TF32 matmuls off), then the wgmma forward, dq and dk/dv kernels at
head_dim 256 (bf16 and fp16, and 160 and 200 zero-padded to them) against
their plain versions, with their launches and, at shapes whose dk/dv
splits, two calls bit for bit; `check small`, `check wide`, `check f32`
and `check 256` run only those; `time 256` times the forward, dq and
dk/dv at 256 at Gemma's four shapes beside their bounds and SDPA's
forward and backward, dk/dv at every split it can take, and its
partials' reduce apart (torch.profiler);
`time`
times the forward, dq and dk/dv at
bench-1b's shape (B=4, Hq=16, Hkv=8, S=4096, D=128, causal bf16) and the
forward at the serving shape (B=8, H=32, S=256), each the mean of 20 calls
queued behind a spin kernel, so the device runs them back to back.  To
compare two versions of a kernel on one card, unpack each tree into a
directory of its own and run `time` from each in turns (A, B, B, A) in one
call; each tree builds its own library under its own `build/`.
`chip_smoke.py` is the full check; this is the short loop for kernel work.
"""
from __future__ import annotations

import pathlib
import sys
import tempfile
import time

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
# The small-head-dim kernels: 64-row tiles, so S on both sides of 64 and
# 128; GQA groups 1, 2 and 4; the `tiny` probe's S = 8 and 16.
SMALL_CHECK_SHAPES = [
    (b, hq, hkv, s, d, causal, dtype)
    for b, hq, hkv in ((2, 4, 2), (2, 4, 4))
    for s in (1, 5, 8, 16, 17, 63, 64, 65, 127, 128, 129)
    for d in (16, 32)
    for causal in (True, False)
    for dtype in (torch.bfloat16, torch.float16)
] + [(1, 8, 2, 1024, 16, True, torch.bfloat16),
     (3, 4, 4, 300, 32, False, torch.float16)]
# The wide kernels (head_dim 80, 96 and 256: 64-row K/V tiles, 32 at 256)
# at S on both sides of 32, 64 and 128, GQA groups 1, 4 and 8, causal and
# not, bf16 and fp16; then head_dims that no kernel takes, each through
# its zero-padded route (8 -> 16, 24 -> 32, 48 -> 64, 72 -> 80, 100 and
# 112 -> 128, 160 and 200 -> 256).
WIDE_CHECK_SHAPES = [
    (b, hq, hkv, s, d, causal, dtype)
    for d in (80, 96, 256)
    for b, hq, hkv in ((2, 4, 4), (1, 8, 2), (1, 8, 1))
    for s in (1, 17, 31, 33, 63, 65, 129)
    for causal in (True, False)
    for dtype in ((torch.bfloat16, torch.float16) if hkv == 2
                  else (torch.bfloat16,))
] + [(1, 8, 1, 1024, 256, True, torch.bfloat16),
     (1, 8, 8, 1024, 96, True, torch.bfloat16)] + [
    (2, 4, 2, s, d, causal, torch.bfloat16)
    for d in (8, 24, 48, 72, 100, 112, 160, 200)
    for s in (17, 65) for causal in (True, False)]
# The f32 kernels: the JAX package's own Pallas test shapes
# (tests/test_ops.py: (2, 4, 4, 256, 64) and GQA (2, 4, 2, 256, 64),
# causal and not; the backward's (1, 2, 2, 256, 64) and (1, 4, 2, 256,
# 64)); every native f32 width at S one short of and one past its tiles
# (16-, 32- and 64-row tiles, and 128), GQA groups 1, 4 and 8, causal and
# not; the training shape of the f32 bench-1b run at S = 1024; then
# head_dims 8-200 through the zero-padded route (8 -> 16, 24 -> 32,
# 48 -> 64, 72 -> 80, 100 and 112 -> 128, 160 and 200 -> 256).
F32_CHECK_SHAPES = [
    (b, hq, hkv, 256, 64, causal, torch.float32)
    for b, hq, hkv in ((2, 4, 4), (2, 4, 2), (1, 2, 2), (1, 4, 2))
    for causal in (True, False)
] + [
    (b, hq, hkv, s, d, causal, torch.float32)
    for d in fa.KERNEL_WIDTHS
    for b, hq, hkv in ((2, 4, 4), (1, 8, 2), (1, 8, 1))
    for s in (1, 15, 17, 31, 33, 63, 65, 129)
    for causal in (True, False)
] + [(1, 16, 8, 1024, 128, True, torch.float32)] + [
    (2, 4, 2, s, d, causal, torch.float32)
    for d in (8, 24, 48, 72, 100, 112, 160, 200)
    for s in (17, 65) for causal in (True, False)]
# The f32 route's gates, which a tf32-only product (about 1e-3 at these
# shapes) would fail: out and lse within F32_OUT_TOL + F32_OUT_TOL * |ref|
# of the plain version, dq, dk and dv within F32_NORM_RTOL of its norm.
# An output that is 0 in exact arithmetic (dq and dk at S = 1, where
# dP - delta = dO.V - dO.O cancels) is held to F32_ZERO_ATOL in max-abs:
# the terms cancelled are dot products of D randn pairs (|dO.V| up to
# about 3 sqrt(D), 48 at D = 256), an f32-class dot's error is about
# 2^-21 of that (2.3e-5), and dq and dk scale it by D^-1/2 and |K| or
# |Q| (up to about 4): near 2e-5 at D = 256; 1e-4 leaves room and is
# still far below a wrong kernel's O(1).
F32_OUT_TOL = 5e-5
F32_NORM_RTOL = 5e-5
F32_ZERO_ATOL = 1e-4
SPIN_CYCLES = 20_000_000


def _inputs(gen, b, hq, hkv, s, d, dtype):
    q, g = (torch.randn((b, hq, s, d), generator=gen,
                        device='cuda').to(dtype) for _ in range(2))
    k, v = (torch.randn((b, hkv, s, d), generator=gen,
                        device='cuda').to(dtype) for _ in range(2))
    return q, k, v, g


def _norm_rel(x, ref) -> float:
    return ((x.float() - ref.float()).norm() / ref.float().norm()).item()


SMALL_KERNELS = ('flash_attention_fwd_small', 'flash_attention_bwd_dq_small',
                 'flash_attention_bwd_dkv_small')


def check_small() -> None:
    """The forward, dq and dk/dv at head_dim 16 and 32 against their
    plain versions (forward max-abs; backward norm-relative and max-abs),
    with each small wrapper's launches per case (1, 2 for the forward)."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    worst = {'fwd': 0.0, 'bwd': 0.0}
    for b, hq, hkv, s, d, causal, dtype in SMALL_CHECK_SHAPES:
        q, k, v, g = _inputs(gen, b, hq, hkv, s, d, dtype)
        before = [getattr(fa, name).launches for name in SMALL_KERNELS]
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                          return_residuals=True)
        no_lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        delta = (g.float() * out.float()).sum(-1)
        dq = fa.flash_attention_bwd_dq(q, k, v, g, lse, delta, causal)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal)
        torch.cuda.synchronize()
        launches = [getattr(fa, name).launches - n
                    for name, n in zip(SMALL_KERNELS, before)]
        ref, ref_lse = fa.flash_attention_fwd_reference(
            q, k, v, causal=causal, return_residuals=True)
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        worst['fwd'] = max(worst['fwd'], err, lse_err)
        refs = (fa.flash_attention_bwd_dq_reference(q, k, v, g, lse, delta,
                                                    causal),
                *fa.flash_attention_bwd_dkv_reference(q, k, v, g, lse,
                                                      delta, causal))
        bwd = []
        for name, x, r in zip(('dq', 'dk', 'dv'), (dq, dk, dv), refs):
            rel = _norm_rel(x, r)
            worst['bwd'] = max(worst['bwd'], rel)
            bwd.append(f'{name} {rel:.3e}/'
                       f'{(x.float() - r.float()).abs().max().item():.3e}')
        bwd = ' '.join(bwd)
        print(f'{(b, hq, hkv, s, d, causal, str(dtype)[6:])}: out max '
              f'{err:.3e} lse max {lse_err:.3e} no-lse equal '
              f'{bool(torch.equal(out, no_lse))} | norm-rel/max-abs {bwd} '
              f'| launches {launches}', flush=True)
    print(f'small forward worst max-abs {worst["fwd"]:.3e}; small backward '
          f'worst norm-rel {worst["bwd"]:.3e}', flush=True)


WIDE_KERNELS = ('flash_attention_fwd_wide', 'flash_attention_bwd_dq_wide',
                'flash_attention_bwd_dkv_wide')
ROUTE_COUNTERS = (*(f'flash_attention_{k}{suffix}.launches'
                    for suffix in ('', '_small', '_wide', '_256', '_f32')
                    for k in ('fwd', 'bwd_dq', 'bwd_dkv')
                    if hasattr(fa, f'flash_attention_{k}{suffix}')),
                  *(f'flash_attention_{k}.padded_launches'
                    for k in ('fwd', 'bwd_dq', 'bwd_dkv')))


def _counters() -> dict:
    return {name: getattr(getattr(fa, name.split('.')[0]),
                          name.split('.')[1]) for name in ROUTE_COUNTERS}


def check_wide() -> None:
    """The forward, dq and dk/dv at WIDE_CHECK_SHAPES against their plain
    versions (forward max-abs beyond one output ulp, lse max-abs;
    backward norm-relative), with the counters each case moved: the
    kernel of kernel_width(D) launched once per call, and the padded
    counters once per call where D is no kernel width."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    worst = {'fwd': 0.0, 'lse': 0.0, 'bwd': 0.0}
    for b, hq, hkv, s, d, causal, dtype in WIDE_CHECK_SHAPES:
        q, k, v, g = _inputs(gen, b, hq, hkv, s, d, dtype)
        before = _counters()
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                          return_residuals=True)
        delta = (g.float() * out.float()).sum(-1)
        dq = fa.flash_attention_bwd_dq(q, k, v, g, lse, delta, causal)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal)
        torch.cuda.synchronize()
        moved = {name: n - before[name] for name, n in _counters().items()
                 if n != before[name]}
        ref, ref_lse = fa.flash_attention_fwd_reference(
            q, k, v, causal=causal, return_residuals=True)
        ref = ref.float()
        ulp = torch.finfo(dtype).eps * torch.exp2(torch.floor(torch.log2(
            ref.abs().clamp_min(torch.finfo(dtype).tiny))))
        beyond = ((out.float() - ref).abs() - ulp).max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        worst['fwd'] = max(worst['fwd'], beyond)
        worst['lse'] = max(worst['lse'], lse_err)
        refs = (fa.flash_attention_bwd_dq_reference(q, k, v, g, lse, delta,
                                                    causal),
                *fa.flash_attention_bwd_dkv_reference(q, k, v, g, lse,
                                                      delta, causal))
        bwd = []
        for name, x, r in zip(('dq', 'dk', 'dv'), (dq, dk, dv), refs):
            rel = _norm_rel(x, r) if r.float().abs().max() > 1e-5 else 0.0
            worst['bwd'] = max(worst['bwd'], rel)
            bwd.append(f'{name} {rel:.3e}/'
                       f'{(x.float() - r.float()).abs().max().item():.3e}')
        print(f'{(b, hq, hkv, s, d, causal, str(dtype)[6:])} -> width '
              f'{fa.kernel_width(d)}: out beyond one ulp {beyond:.3e} lse '
              f'{lse_err:.3e} | norm-rel/max-abs {" ".join(bwd)} | '
              f'{moved}', flush=True)
    print(f'wide/padded forward worst beyond one ulp {worst["fwd"]:.3e}, '
          f'lse {worst["lse"]:.3e}; backward worst norm-rel '
          f'{worst["bwd"]:.3e}', flush=True)


def f32_case(gen, shape) -> dict:
    """One F32_CHECK_SHAPES case on the card: the forward (out, lse), dq and
    dk/dv against their plain versions in full f32, and the counters the
    calls moved.  Returns {'out', 'lse': max(|d| - F32_OUT_TOL * |ref|),
    which the gate holds to F32_OUT_TOL; 'out_abs', 'lse_abs': max-abs;
    'dq', 'dk', 'dv': norm-rel (0 where the output is 0 in exact
    arithmetic and the kernel's within F32_ZERO_ATOL, inf where it is
    not); 'dq_abs', 'dkv_abs': max-abs; 'zero_abs': max |kernel| of the
    outputs that are 0 in exact arithmetic; 'moved': counters}."""
    b, hq, hkv, s, d, causal, dtype = shape
    q, k, v, g = _inputs(gen, b, hq, hkv, s, d, dtype)
    before = _counters()
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                      block_size=s, return_residuals=True)
    delta = (g.float() * out.float()).sum(-1)
    dq = fa.flash_attention_bwd_dq(q, k, v, g, lse, delta, causal)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal)
    torch.cuda.synchronize()
    nums = {'moved': {name: n - before[name]
                      for name, n in _counters().items()
                      if n != before[name]}}
    ref, ref_lse = fa.flash_attention_fwd_reference(
        q, k, v, causal=causal, return_residuals=True)
    for key, x, r in (('out', out, ref), ('lse', lse, ref_lse)):
        diff = (x - r).abs()
        nums[f'{key}_abs'] = diff.max().item()
        nums[key] = (diff - F32_OUT_TOL * r.abs()).max().item()
    refs = (fa.flash_attention_bwd_dq_reference(q, k, v, g, lse, delta,
                                                causal),
            *fa.flash_attention_bwd_dkv_reference(q, k, v, g, lse, delta,
                                                  causal))
    nums['zero_abs'] = 0.0
    for name, x, r in zip(('dq', 'dk', 'dv'), (dq, dk, dv), refs):
        key = 'dq_abs' if name == 'dq' else 'dkv_abs'
        nums[key] = max(nums.get(key, 0.0), (x - r).abs().max().item())
        if not (x.dtype == dtype and bool(torch.isfinite(x).all())):
            nums[name] = float('inf')
        elif r.abs().max().item() <= F32_ZERO_ATOL:
            nums['zero_abs'] = max(nums['zero_abs'], x.abs().max().item())
            nums[name] = (0.0 if x.abs().max().item() <= F32_ZERO_ATOL
                          else float('inf'))
        else:
            nums[name] = _norm_rel(x, r)
    if not (out.dtype == dtype and bool(torch.isfinite(out).all())):
        nums['out'] = float('inf')
    return nums


def f32_want(d, calls=1) -> dict:
    """The counters `calls` calls of the forward, dq and dk/dv in f32 at
    head_dim d must move: the f32 wrappers, and the public ones' padded
    counts where d is no f32 width."""
    want = {f'flash_attention_{k}_f32.launches': calls
            for k in ('fwd', 'bwd_dq', 'bwd_dkv')}
    if fa.kernel_width(d) != d:
        want.update({f'flash_attention_{k}.padded_launches': calls
                     for k in ('fwd', 'bwd_dq', 'bwd_dkv')})
    return want


def check_f32(quiet: bool = False) -> dict:
    """Every F32_CHECK_SHAPES case under the f32 gates, each call launching
    its f32 kernel once (f32_want); f64 and head_dim 257 refused.  Prints
    each case (with `quiet`, the worst numbers of each head_dim instead)
    and the worst numbers, raises on the first case past a gate; returns
    the worst numbers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device='cuda').manual_seed(0)
    keys = ('out', 'lse', 'out_abs', 'lse_abs', 'dq', 'dk', 'dv', 'dq_abs',
            'dkv_abs', 'zero_abs')
    worst = dict.fromkeys(keys, -float('inf'))
    by_d = {}
    for shape in F32_CHECK_SHAPES:
        nums = f32_case(gen, shape)
        moved = nums.pop('moved')
        if not quiet:
            print(f'{(*shape[:6], "f32")} -> width '
                  f'{fa.kernel_width(shape[4])}: out '
                  f'{nums["out_abs"]:.3e} lse {nums["lse_abs"]:.3e} | '
                  f'norm-rel dq {nums["dq"]:.3e} dk {nums["dk"]:.3e} dv '
                  f'{nums["dv"]:.3e} | {moved}', flush=True)
        row = by_d.setdefault(shape[4], dict.fromkeys(keys, -float('inf')))
        for key, x in nums.items():
            worst[key] = max(worst[key], x)
            row[key] = max(row[key], x)
        if moved != f32_want(shape[4]):
            raise SystemExit(f'f32 at {shape} moved {moved}, expected '
                             f'{f32_want(shape[4])}')
        if max(nums['out'], nums['lse']) > F32_OUT_TOL or max(
                nums['dq'], nums['dk'], nums['dv']) > F32_NORM_RTOL:
            raise SystemExit(f'the f32 kernels disagree with their plain '
                             f'versions at {shape}: {nums}')
    if quiet:
        for d, row in sorted(by_d.items()):
            print(f'  f32 head_dim {d} -> width '
                  f'{fa.kernel_width(d)}: '
                  f'{sum(c[4] == d for c in F32_CHECK_SHAPES)} cases, worst '
                  f'out max-abs {row["out_abs"]:.3e} lse '
                  f'{row["lse_abs"]:.3e}, norm-rel dq {row["dq"]:.3e} dk '
                  f'{row["dk"]:.3e} dv {row["dv"]:.3e}', flush=True)
    for dtype, d in ((torch.float64, 64), (torch.float32, 257)):
        q = torch.zeros((1, 2, 16, d), dtype=dtype, device='cuda')
        try:
            fa.flash_attention_fwd(q, q, q)
        except ValueError as e:
            print(f'{dtype} at head_dim {d} refused: {e}', flush=True)
        else:
            raise SystemExit(f'{dtype} at head_dim {d} was not refused')
    print(f'f32 ({len(F32_CHECK_SHAPES)} cases): worst out max-abs '
          f'{worst["out_abs"]:.3e}, lse {worst["lse_abs"]:.3e} (gate '
          f'{F32_OUT_TOL} + {F32_OUT_TOL}*|ref|); norm-rel dq '
          f'{worst["dq"]:.3e} dk {worst["dk"]:.3e} dv {worst["dv"]:.3e} '
          f'(gate {F32_NORM_RTOL}); outputs 0 in exact arithmetic max-abs '
          f'{worst["zero_abs"]:.3e} (gate {F32_ZERO_ATOL}); launches exact',
          flush=True)
    return worst


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
    check_wide()
    check_f32()
    check_256()


# The wgmma forward, dq and dk/dv kernels at head_dim 256 (bf16 and fp16):
# S on both sides of their 32-row (dq's K/V stages), 64-row (the
# forward's K/V stages and consumer slabs, dk/dv's tiles) and 128-row (the
# forward's and dq's q tiles) edges and S = 1000; GQA groups 1, 8 and 16;
# causal and not; then head_dims 160 and 200, zero-padded to 256.  Many of
# these take a split dk/dv (plan_dkv_256_split), so the split, its
# partials and their reduce are checked here too.  Gates: PERF.md section
# 2's (out within FWD_OUT_ATOL + FWD_OUT_RTOL |ref|, lse within
# FWD_LSE_ATOL; dq, dk, dv within BWD_NORM_RTOL norm-relative; an output
# 0 in exact arithmetic within BWD_ZERO_ATOL).
BWD_256_CHECK_SHAPES = [
    (b, hq, hkv, s, 256, causal, dtype)
    for b, hq, hkv in ((2, 4, 4), (1, 8, 1), (1, 16, 1))
    for s in (1, 17, 31, 33, 63, 64, 65, 127, 129, 1000)
    for causal in (True, False)
    for dtype in (torch.bfloat16, torch.float16)
] + [(2, 8, 1, s, d, causal, torch.bfloat16)
     for d in (160, 200) for s in (17, 129) for causal in (True, False)]
FWD_OUT_ATOL = 1e-2
FWD_OUT_RTOL = 1e-2
FWD_LSE_ATOL = 1e-3
BWD_NORM_RTOL = 1e-2
BWD_ZERO_ATOL = 1e-5
# Gemma-2B's MQA shapes, at which dk/dv splits (causal bf16): two calls of
# each kernel give the same bits.
BWD_256_REPEAT_SHAPES = [(2, 8, 1, 1024, 256), (8, 8, 1, 256, 256)]
# Gemma's attention at the training shape (2 x 4096) and the serving
# bucket's (8 x 256), causal bf16: (b, hq, hkv, s, d).
BWD_256_TIMED = {'gemma-7b training': (2, 16, 16, 4096, 256),
                 'gemma-2b training': (2, 8, 1, 4096, 256),
                 'gemma-2b serving': (8, 8, 1, 256, 256),
                 'gemma-7b serving': (8, 16, 16, 256, 256)}
# An H100 SXM's bf16 tensor-core peak and HBM rate (the bounds').
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12


def bwd_bound_ms(kind: str, b, hq, hkv, s, d, causal=True, itemsize=2):
    """(least ms, 'operations' or 'bytes') of the forward ('fwd'), dq
    ('dq') or dk/dv ('dkv'): their inputs (the forward's q, k, v; the
    backward's q, dO, k, v, lse and delta) read once and the outputs
    written once over the HBM rate, vs 4 D (forward), 6 D (dq) or 8 D
    (dk/dv) flops per (q, k) pair this input needs over the bf16 peak."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = {'fwd': 4, 'dq': 6, 'dkv': 8}[kind] * b * hq * pairs * d
    if kind == 'fwd':
        nbytes = (2 * b * hq * s * d + 2 * b * hkv * s * d) * itemsize
    else:
        nbytes = ((2 * b * hq * s * d + 2 * b * hkv * s * d) * itemsize +
                  2 * b * hq * s * 4 +
                  (b * hq * s * d if kind == 'dq' else 2 * b * hkv * s * d) *
                  itemsize)
    t_flops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_S
    return (max(t_flops, t_bytes) * 1e3,
            'operations' if t_flops > t_bytes else 'bytes')


def check_256(quiet: bool = False) -> dict:
    """Every BWD_256_CHECK_SHAPES case: the forward (with lse, and
    without: the same out bits), dq and dk/dv against their plain
    versions, each call launching the `_256` wrapper's kernel once (and
    the padded counters at 160 and 200); then BWD_256_REPEAT_SHAPES' two
    calls bit for bit.  Prints each case (with `quiet`, the worst of each
    head_dim), raises on a miss; returns the worst numbers and the splits
    seen."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    worst = {'out': 0.0, 'lse': 0.0, 'dq': 0.0, 'dk': 0.0, 'dv': 0.0}
    splits = set()
    for shape in BWD_256_CHECK_SHAPES:
        b, hq, hkv, s, d, causal, dtype = shape
        q, k, v, g = _inputs(gen, b, hq, hkv, s, d, dtype)
        before = _counters()
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                          block_size=s,
                                          return_residuals=True)
        no_lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                        block_size=s)
        delta = (g.float() * out.float()).sum(-1)
        dq = fa.flash_attention_bwd_dq(q, k, v, g, lse, delta, causal)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal)
        torch.cuda.synchronize()
        moved = {name: n - before[name] for name, n in _counters().items()
                 if n != before[name]}
        want = {'flash_attention_fwd_256.launches': 2,
                'flash_attention_bwd_dq_256.launches': 1,
                'flash_attention_bwd_dkv_256.launches': 1}
        if d != 256:
            want.update({'flash_attention_fwd.padded_launches': 2,
                         'flash_attention_bwd_dq.padded_launches': 1,
                         'flash_attention_bwd_dkv.padded_launches': 1})
        if moved != want:
            raise SystemExit(f'{shape} moved {moved}, expected {want}')
        split = fa.plan_dkv_256_split(b, hq, hkv, s, causal,
                                      fa._sm_count(q.device))
        splits.add(split)
        ref, ref_lse = fa.flash_attention_fwd_reference(
            q, k, v, causal=causal, return_residuals=True)
        diff = (out.float() - ref.float()).abs()
        nums = {'out': diff.max().item(),
                'lse': (lse - ref_lse).abs().max().item()}
        if not (out.dtype == dtype and out.shape == ref.shape and
                bool(torch.isfinite(out).all()) and
                bool((diff <= FWD_OUT_ATOL +
                      FWD_OUT_RTOL * ref.float().abs()).all()) and
                nums['lse'] <= FWD_LSE_ATOL and torch.equal(out, no_lse)):
            raise SystemExit(f'the 256 forward disagrees with its plain '
                             f'version at {shape}: {nums}, without lse the '
                             f'same bits {torch.equal(out, no_lse)}')
        refs = (fa.flash_attention_bwd_dq_reference(q, k, v, g, lse, delta,
                                                    causal),
                *fa.flash_attention_bwd_dkv_reference(q, k, v, g, lse,
                                                      delta, causal))
        for name, x, r in zip(('dq', 'dk', 'dv'), (dq, dk, dv), refs):
            ok = (x.dtype == dtype and x.shape == r.shape and
                  bool(torch.isfinite(x).all()))
            if r.float().abs().max().item() <= BWD_ZERO_ATOL:
                err = (x.float() - r.float()).abs().max().item()
                nums[name] = 0.0 if ok and err <= BWD_ZERO_ATOL else (
                    float('inf'))
            else:
                nums[name] = _norm_rel(x, r) if ok else float('inf')
        for name, x in nums.items():
            worst[name] = max(worst[name], x)
        if not quiet:
            print(f'{(b, hq, hkv, s, d, causal, str(dtype)[6:])} split '
                  f'{split}: out max-abs {nums["out"]:.3e} lse '
                  f'{nums["lse"]:.3e}; norm-rel dq {nums["dq"]:.3e} dk '
                  f'{nums["dk"]:.3e} dv {nums["dv"]:.3e}', flush=True)
        if max(nums[name] for name in ('dq', 'dk', 'dv')) > BWD_NORM_RTOL:
            raise SystemExit(f'the 256 backward kernels disagree with their '
                             f'plain versions at {shape}: {nums}')
    for b, hq, hkv, s, d in BWD_256_REPEAT_SHAPES:
        q, k, v, g = _inputs(gen, b, hq, hkv, s, d, torch.bfloat16)
        out, lse = fa.flash_attention_fwd(q, k, v, return_residuals=True)
        delta = (g.float() * out.float()).sum(-1)
        first, second = (
            (fa.flash_attention_bwd_dq(q, k, v, g, lse, delta),
             *fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta))
            for _ in range(2))
        split = fa.plan_dkv_256_split(b, hq, hkv, s, True,
                                      fa._sm_count(q.device))
        same = [bool(torch.equal(x, y)) for x, y in zip(first, second)]
        print(f'{(b, hq, hkv, s, d)} split {split}: two calls bit-identical '
              f'dq/dk/dv {same}', flush=True)
        if split == 1 or not all(same):
            raise SystemExit(f'{(b, hq, hkv, s, d)}: split {split}, '
                             f'bit-identical {same}')
    print(f'256 kernels ({len(BWD_256_CHECK_SHAPES)} cases, splits '
          f'{sorted(splits)}): forward worst out max-abs {worst["out"]:.3e} '
          f'(gate {FWD_OUT_ATOL} + {FWD_OUT_RTOL}|ref|) lse '
          f'{worst["lse"]:.3e} (gate {FWD_LSE_ATOL}); worst norm-rel dq '
          f'{worst["dq"]:.3e} dk {worst["dk"]:.3e} dv {worst["dv"]:.3e} '
          f'(gate {BWD_NORM_RTOL}); launches exact; repeats bit-identical',
          flush=True)
    return {'worst': worst, 'splits': sorted(splits)}


def dkv_256_at_split(q, k, v, g, lse, delta, split, causal=True):
    """(dk, dv) from the dk/dv kernel at 256 at a given split (not the
    planned one), through its C entry; not counted on any wrapper."""
    b, hq, s, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    partial = (torch.empty((split, 2, *k.shape), dtype=torch.float32,
                           device=q.device) if split > 1 else None)
    err = fa._LIBRARY.get().skytpu_flash_attention_bwd_dkv_256(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b,
        hq, k.shape[1], s, d, fa._DTYPE_CODES[q.dtype], d**-0.5, int(causal),
        None if partial is None else partial.data_ptr(), split,
        fa._stream(q.device))
    fa._raise_on(err, 'flash_attention_bwd_dkv_256')
    return dk, dv


def device_ms_by_kernel(fn, names, calls: int = 5) -> dict:
    """{name: device ms per call of the kernels whose symbol holds `name`}
    over `calls` calls of `fn` under torch.profiler; None where the trace
    holds no such kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names)
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        for name in names:
            if name in evt.key:
                out[name] = (out[name] or 0.0) + (
                    evt.self_device_time_total / 1e3 / calls)
    return out


def time_256() -> dict:
    """The forward, dq and dk/dv at 256 at BWD_256_TIMED's shapes (CUDA
    events, the mean of 20 calls behind a spin kernel), SDPA's forward and
    backward (dq, dk and dv in one call) on the same inputs, the bounds;
    dk/dv at each split from 1 up (forced through the C entry, held to
    the planned split's result)
    and, at the planned split, its main kernel and the partials' reduce
    apart (torch.profiler).  Prints each line; returns the numbers."""
    import torch.nn.functional as F
    gen = torch.Generator(device='cuda').manual_seed(0)
    results = {}
    for label, (b, hq, hkv, s, d) in BWD_256_TIMED.items():
        q, k, v, g = _inputs(gen, b, hq, hkv, s, d, torch.bfloat16)
        out, lse = fa.flash_attention_fwd(q, k, v, return_residuals=True)
        delta = (g.float() * out.float()).sum(-1)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                                  enable_gqa=True)
        sdpa_ms = _time_ms(lambda: torch.autograd.grad(
            sdpa_out, leaves, g, retain_graph=True))
        del sdpa_out, leaves
        with torch.no_grad():
            sdpa_fwd_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
        row = {'shape': [b, hq, hkv, s, d, True, 'bfloat16'],
               'sdpa_bwd_ms': sdpa_ms, 'sdpa_fwd_ms': sdpa_fwd_ms}
        bound, by = bwd_bound_ms('fwd', b, hq, hkv, s, d)
        ms = _time_ms(lambda: fa.flash_attention_fwd_256(
            q, k, v, return_residuals=True))
        row['fwd'] = {'ms': ms, 'bound_ms': bound, 'bound_by': by,
                      'over_sdpa': ms / sdpa_fwd_ms}
        print(f'{label} fwd_256 ms {ms:.4f} bound {bound:.4f} ({by}) '
              f'x{ms / bound:.2f}; sdpa forward {sdpa_fwd_ms:.4f} ms (x'
              f'{ms / sdpa_fwd_ms:.2f})', flush=True)
        for kind, fn in (
                ('dq', lambda: fa.flash_attention_bwd_dq_256(
                    q, k, v, g, lse, delta)),
                ('dkv', lambda: fa.flash_attention_bwd_dkv_256(
                    q, k, v, g, lse, delta))):
            bound, by = bwd_bound_ms(kind, b, hq, hkv, s, d)
            ms = _time_ms(fn)
            row[kind] = {'ms': ms, 'bound_ms': bound, 'bound_by': by}
            print(f'{label} {kind}_256 ms {ms:.4f} bound {bound:.4f} '
                  f'({by}) x{ms / bound:.2f}', flush=True)
        pair = row['dq']['ms'] + row['dkv']['ms']
        row['pair_over_sdpa'] = pair / sdpa_ms
        planned = fa.plan_dkv_256_split(b, hq, hkv, s, True,
                                        fa._sm_count(q.device))
        row['split'] = planned
        want = fa.flash_attention_bwd_dkv_256(q, k, v, g, lse, delta)
        n_tiles = -(-s // fa.DKV_256_BLOCK)
        row['dkv_by_split'] = {}
        split = 1
        while split <= min(fa.DKV_256_MAX_SPLIT, hq // hkv * n_tiles):
            got = dkv_256_at_split(q, k, v, g, lse, delta, split)
            rel = max(_norm_rel(x, y) for x, y in zip(got, want))
            if rel > BWD_NORM_RTOL:
                raise SystemExit(f'{label}: dk/dv at split {split} is '
                                 f'{rel} from the planned split\'s')
            row['dkv_by_split'][split] = _time_ms(
                lambda sp=split: dkv_256_at_split(q, k, v, g, lse, delta,
                                                  sp))
            split *= 2
        if planned > 1:
            row['dkv_parts_ms'] = device_ms_by_kernel(
                lambda: fa.flash_attention_bwd_dkv_256(q, k, v, g, lse,
                                                       delta),
                ('fa_bwd_dkv_256_kernel', 'fa_bwd_dkv_256_reduce'))
            row['partial_bytes'] = planned * b * hkv * s * d * 8
        print(f'{label} b={b} hq={hq} hkv={hkv} s={s} d={d}: dq + dk/dv '
              f'{pair:.4f} ms, sdpa backward {sdpa_ms:.4f} ms (pair / sdpa '
              f'{pair / sdpa_ms:.2f}); planned split {planned}; dk/dv by '
              f'split ' + ', '.join(f'{sp}: {ms:.4f}' for sp, ms in
                                    row['dkv_by_split'].items()) +
              (f'; at the planned split main / reduce ms '
               f'{row["dkv_parts_ms"]}, partials '
               f'{row["partial_bytes"] / 1e6:.1f} MB' if planned > 1
               else ''), flush=True)
        results[label] = row
        del q, k, v, g, out, lse, delta, want, got
        torch.cuda.empty_cache()
    return results


def build_fresh(csrc: pathlib.Path) -> None:
    """Compile and link every source of `csrc` afresh (the library's own
    build steps, into a temporary directory) and print nvcc's report and
    the seconds."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        log = fa._LIBRARY._compile_and_link(  # pylint: disable=protected-access
            sorted(csrc.glob('*.cu')), pathlib.Path(tmp),
            pathlib.Path(tmp) / fa.library_name(csrc))
        seconds = time.perf_counter() - t0
    print(log)
    print(f'fresh build of {csrc} ({len(list(csrc.glob("*.cu")))} sources): '
          f'{seconds:.2f} s', flush=True)


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
    del q, k, v, g, out, lse, delta
    # f32 (3xTF32) at the f32 serving and training shapes.
    for label, shape in (('f32 serving', (8, 32, 32, 256, 128)),
                         ('f32 training', (2, 16, 8, 4096, 128))):
        if not any(only in f'{label} {kind}' for kind in ('fwd', 'dq',
                                                          'dkv')):
            continue
        q, k, v, g = _inputs(gen, *shape, torch.float32)
        out, lse = fa.flash_attention_fwd(q, k, v, return_residuals=True)
        delta = (g * out).sum(-1)
        for kind, fn in (
                ('fwd', lambda: fa.flash_attention_fwd(
                    q, k, v, return_residuals=True)),
                ('dq', lambda: fa.flash_attention_bwd_dq(
                    q, k, v, g, lse, delta)),
                ('dkv', lambda: fa.flash_attention_bwd_dkv(
                    q, k, v, g, lse, delta))):
            if only in f'{label} {kind}':
                print(f'{label} {kind} ms {_time_ms(fn):.4f}', flush=True)
        del q, k, v, g, out, lse, delta
    # dq and dk/dv at 256 (wgmma) at Gemma's shapes, beside SDPA's backward.
    if only in ('', '256'):
        time_256()


def main(argv) -> int:
    mode = argv[1] if len(argv) > 1 else 'check'
    if mode == 'build' and len(argv) > 2:
        build_fresh(pathlib.Path(argv[2]))
    elif mode == 'build':
        print(fa.build())
    elif mode == 'check':
        {'small': check_small, 'wide': check_wide, 'f32': check_f32,
         '256': check_256}.get(''.join(argv[2:3]), check)()
    elif mode == 'time':
        time_kernels(argv[2] if len(argv) > 2 else '')
    else:
        print(__doc__)
        return 2
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv))
