"""Port attention ops against the JAX package's: `mha_reference`, and the
flash kernels' plain versions (what CPU tensors take, forward and
backward) against the Pallas kernels in interpret mode, and the autograd
op against autograd through `mha_reference`.  Inputs come from a seeded numpy generator and
go to both frameworks as numpy; JAX stays on the CPU.  Also, without a
GPU: the kernel library's name covers every source and header, and each
C entry point's parameters match its ctypes signature."""
import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops import attention as jax_attn
from skypilot_tpu.ops.pallas import flash_attention as jax_fa
from skypilot_tpu_torch.ops import attention as torch_attn
from skypilot_tpu_torch.ops.cuda import flash_attention as torch_fa

torch.set_num_threads(1)


def _qkv(b=2, h=4, s=256, d=64, hkv=None, seed=0):
    rng = np.random.default_rng(seed)
    hkv = hkv or h
    return (rng.standard_normal((b, h, s, d), np.float32),
            rng.standard_normal((b, hkv, s, d), np.float32),
            rng.standard_normal((b, hkv, s, d), np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# f32 on both sides: only summation order differs.
MHA_ATOL = 1e-5


@pytest.mark.parametrize('causal,hkv', [(True, None), (False, None),
                                        (True, 2)])
def test_mha_reference_matches_jax(causal, hkv):
    q, k, v = _qkv(s=64, hkv=hkv)
    want = np.asarray(jax_attn.mha_reference(q, k, v, causal=causal))
    got = torch_attn.mha_reference(*_t(q, k, v), causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=MHA_ATOL, rtol=0)


def test_mha_reference_positions_fully_masked_row():
    """Cache-style masking from absolute positions; row 0 of batch 1 sees
    no key (its position precedes every kv position) and must be 0."""
    q, k, v = _qkv(b=2, h=4, s=8, d=16, hkv=2)
    q = q[:, :, :3]
    seg = np.array([[5, 6, 7], [1, 9, 10]], np.int32)
    kv = np.tile(np.arange(2, 10, dtype=np.int32), (2, 1))
    want = np.asarray(jax_attn.mha_reference(
        q, k, v, causal=True, segment_positions=seg, kv_positions=kv))
    got = torch_attn.mha_reference(
        *_t(q, k, v), causal=True,
        segment_positions=torch.from_numpy(seg),
        kv_positions=torch.from_numpy(kv)).numpy()
    assert np.all(got[1, :, 0] == 0.0)
    np.testing.assert_allclose(got, want, atol=MHA_ATOL, rtol=0)


# The interpret-mode Pallas kernel's own tolerance against the reference
# (tests/test_ops.py): blocked online softmax vs one-shot f32.
FLASH_ATOL = 5e-3


@pytest.mark.parametrize('causal,hkv', [(True, None), (False, None),
                                        (True, 2)])
def test_flash_fwd_plain_matches_pallas_interpret(causal, hkv):
    q, k, v = _qkv(b=2, h=4, s=256, d=64, hkv=hkv)
    want_out, want_lse = jax_fa.flash_attention_fwd(
        q, k, v, causal=causal, block_size=128, interpret=True,
        return_residuals=True)
    before = torch_fa.flash_attention_fwd.launches
    got_out, got_lse = torch_fa.flash_attention_fwd(
        *_t(q, k, v), causal=causal, block_size=128, return_residuals=True)
    assert torch_fa.flash_attention_fwd.launches == before  # CPU: no kernel
    assert got_out.dtype == torch.float32 and got_lse.shape == (2, 4, 256)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=FLASH_ATOL, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=FLASH_ATOL, rtol=0)
    # The public op returns the same output.
    np.testing.assert_allclose(
        torch_attn.flash_attention(*_t(q, k, v), causal=causal,
                                   block_size=128).numpy(),
        got_out.numpy(), atol=0, rtol=0)


# The `tiny` configs' head_dim 16 (and 32) go to the small-head-dim
# kernel on the card, 80, 96 (Phi-2's and Phi-3-mini's widths) to the wide
# one, 256 (Gemma's) to the wgmma one of that width, and any other
# head_dim (8, 48, 100 here) zero-padded to the next kernel width; the
# plain version the CPU takes is the same function at every head_dim, GQA
# 4 -> 2.  In f32 (these
# inputs) every width is native on the card (16, 32, 64, 80, 96, 128,
# 256): 128 is here too, 64 in the test above.
@pytest.mark.parametrize('s,d,causal', [(8, 16, True), (16, 16, True),
                                        (16, 16, False), (128, 16, True),
                                        (128, 32, False), (16, 32, True),
                                        (16, 8, True), (64, 48, False),
                                        (64, 80, True), (16, 96, False),
                                        (128, 96, True), (64, 100, True),
                                        (16, 256, True), (64, 256, False),
                                        (64, 128, True), (16, 128, False)])
def test_flash_fwd_small_head_dims_plain_match_pallas_interpret(s, d,
                                                                causal):
    q, k, v = _qkv(b=2, h=4, s=s, d=d, hkv=2, seed=5)
    want_out, want_lse = jax_fa.flash_attention_fwd(
        q, k, v, causal=causal, interpret=True, return_residuals=True)
    names = ('flash_attention_fwd', 'flash_attention_fwd_small',
             'flash_attention_fwd_wide', 'flash_attention_fwd_256')
    before = [getattr(torch_fa, name).launches for name in names]
    for fn in (torch_fa.flash_attention_fwd,
               torch_fa.flash_attention_fwd_small,
               torch_fa.flash_attention_fwd_wide,
               torch_fa.flash_attention_fwd_256):
        got_out, got_lse = fn(*_t(q, k, v), causal=causal,
                              return_residuals=True)
        np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                                   atol=FLASH_ATOL, rtol=0)
        np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                                   atol=FLASH_ATOL, rtol=0)
    assert [getattr(torch_fa, name).launches for name in names] == before
    assert torch_fa.flash_attention_fwd.padded_launches == 0


# head_dim -> (the kernel width that runs it, the suffix of the C entries
# of the forward, dq and dk/dv): every kernel width natively, every other
# head_dim up to 256 zero-padded to the next width; at 256 all three run
# the wgmma kernels of that width.
ROUTES = {16: (16, '_small'), 32: (32, '_small'), 64: (64, ''),
          80: (80, '_wide'), 96: (96, '_wide'), 128: (128, ''),
          256: (256, '_256'), 8: (16, '_small'), 24: (32, '_small'),
          48: (64, ''), 72: (80, '_wide'), 100: (128, ''),
          160: (256, '_256'), 200: (256, '_256')}
# Each bf16/fp16 route's widths (the same for the three kernels).
ROUTE_WIDTHS = {'_small': (16, 32), '_wide': (80, 96), '_256': (256,)}
KERNELS = ('fwd', 'bwd_dq', 'bwd_dkv')


def test_forward_dispatches_small_head_dims_to_their_kernel(monkeypatch):
    """On a CUDA tensor the forward, dq and dk/dv take each head_dim to
    the C entry of `kernel_width(head_dim)` (ROUTES): 16 and 32 to the
    small mma.sync kernels (counted on the `_small` wrappers), 80 and 96
    to the wide ones (the `_wide` wrappers), all three at 256 to their
    wgmma kernels of that width (the `_256` wrappers), 64 and 128 to the
    wgmma kernels, with the real
    head_dim^-1/2 as the scale; any other head_dim
    up to 256 reaches the next width's entry on inputs zero-padded to
    that width, counted on that kernel's wrapper and once on the public
    wrapper's `padded_launches`, and comes back at its own head_dim; 257
    is refused naming the limit, and each route's own wrapper refuses
    the other widths.  (The launches themselves are stubbed: the checks,
    the padding and the routing are host code.)"""
    calls = []

    def stub(entry, wrapper, q, *args):
        calls.append((entry, wrapper, q.shape[-1], args[-1]))
        if entry.startswith('skytpu_flash_attention_fwd'):
            out = torch.zeros_like(q)
            return (out, torch.zeros(q.shape[:3])) if args[-2] else out
        if entry.startswith('skytpu_flash_attention_bwd_dq'):
            return torch.zeros_like(q)
        return torch.zeros_like(args[0]), torch.zeros_like(args[0])

    monkeypatch.setattr(torch_fa, '_device_type', lambda *ts: 'cuda')
    for launch in ('_launch_fwd', '_launch_dq', '_launch_dkv'):
        monkeypatch.setattr(torch_fa, launch, stub)
    publics = (torch_fa.flash_attention_fwd, torch_fa.flash_attention_bwd_dq,
               torch_fa.flash_attention_bwd_dkv)
    for d, (width, suffix) in ROUTES.items():
        assert torch_fa.kernel_width(d) == width
        q, k, v = (t.to(torch.bfloat16)
                   for t in _t(*_qkv(b=2, h=4, s=16, d=d, hkv=2)))
        lse = torch.zeros(2, 4, 16)
        padded = [fn.padded_launches for fn in publics]
        out, got_lse = torch_fa.flash_attention_fwd(q, k, v,
                                                    return_residuals=True)
        dq = torch_fa.flash_attention_bwd_dq(q, k, v, q, lse, lse)
        dk, dv = torch_fa.flash_attention_bwd_dkv(q, k, v, q, lse, lse)
        assert calls == [
            (f'skytpu_flash_attention_{kernel}{suffix}',
             getattr(torch_fa, f'flash_attention_{kernel}{suffix}'), width,
             d**-0.5) for kernel in KERNELS], d
        calls.clear()
        assert out.shape == dq.shape == q.shape, d
        assert dk.shape == dv.shape == k.shape and got_lse.shape == (2, 4, 16)
        assert all(x.is_contiguous() for x in (out, dq, dk, dv)), d
        assert [fn.padded_launches - n for fn, n in zip(publics, padded)] == (
            [int(width != d)] * 3), d
        # Each route's own wrapper takes its widths and refuses the others.
        for kernel in KERNELS:
            for suffix_, widths in ROUTE_WIDTHS.items():
                assert torch_fa.route_head_dims(suffix_) == widths
                if d in widths:
                    continue
                args = (q, k, v) if kernel == 'fwd' else (q, k, v, q, lse,
                                                          lse)
                with pytest.raises(ValueError,
                                   match=', '.join(map(str, widths))):
                    getattr(torch_fa, f'flash_attention_{kernel}{suffix_}')(
                        *args)
    assert not calls
    q, k, v = (t.to(torch.bfloat16)
               for t in _t(*_qkv(b=1, h=2, s=16, d=257, hkv=1)))
    lse = torch.zeros(1, 2, 16)
    for call in (lambda: torch_fa.flash_attention_fwd(q, k, v),
                 lambda: torch_fa.flash_attention_bwd_dq(q, k, v, q, lse, lse),
                 lambda: torch_fa.flash_attention_bwd_dkv(q, k, v, q, lse,
                                                          lse)):
        with pytest.raises(ValueError, match='head_dim 257 is past 256'):
            call()
    assert not calls
    for kernel in KERNELS:
        for suffix in ROUTE_WIDTHS:
            # The dk/dv entry at 256 also takes its split's workspace and
            # count (before the stream).
            extra = ([ctypes.c_void_p, ctypes.c_int]
                     if (kernel, suffix) == ('bwd_dkv', '_256') else [])
            base = torch_fa._SIGNATURES[f'skytpu_flash_attention_{kernel}']
            assert torch_fa._SIGNATURES[
                f'skytpu_flash_attention_{kernel}{suffix}'] == (
                    base[:-1] + extra + base[-1:])
            assert (torch_fa.CSRC_DIR /
                    f'flash_attention_{kernel}{suffix}.cu') in (
                        torch_fa.sources())


def test_f32_dispatches_every_head_dim_to_the_f32_kernels(monkeypatch):
    """On a CUDA tensor f32 goes to the f32 kernels (3xTF32) at every
    head_dim 1-256: the forward, dq and dk/dv each reach the `_f32` C
    entry at `kernel_width(d)` (d itself at 16, 32, 64, 80, 96, 128 and
    256, else the next of those, on inputs zero-padded to it and counted
    on the public wrapper's `padded_launches`), in f32 (nothing cast),
    with the real head_dim^-1/2 as the scale, and come back at their own
    head_dim.  f64, a mix of dtypes and head_dim 257 are refused, as are
    f32 on the bf16/fp16 wrappers and bf16 or a head_dim that is no
    kernel width on the f32 ones.  (The launches are stubbed: the checks,
    the padding and the routing are host code.)"""
    calls = []

    def stub(entry, wrapper, q, *args):
        calls.append((entry, wrapper, q.shape[-1], q.dtype, args[-1]))
        if entry.startswith('skytpu_flash_attention_fwd'):
            out = torch.zeros_like(q)
            return (out, torch.zeros(q.shape[:3])) if args[-2] else out
        if entry.startswith('skytpu_flash_attention_bwd_dq'):
            return torch.zeros_like(q)
        return torch.zeros_like(args[0]), torch.zeros_like(args[0])

    monkeypatch.setattr(torch_fa, '_device_type', lambda *ts: 'cuda')
    for launch in ('_launch_fwd', '_launch_dq', '_launch_dkv'):
        monkeypatch.setattr(torch_fa, launch, stub)
    publics = (torch_fa.flash_attention_fwd, torch_fa.flash_attention_bwd_dq,
               torch_fa.flash_attention_bwd_dkv)
    assert torch_fa.KERNEL_WIDTHS == (16, 32, 64, 80, 96, 128, 256)
    for d in range(1, 257):
        width = torch_fa.kernel_width(d)
        assert width == min(w for w in torch_fa.KERNEL_WIDTHS if w >= d)
        q = torch.full((1, 2, 4, d), 0.5)
        k = torch.full((1, 1, 4, d), 0.25)
        lse = torch.zeros(1, 2, 4)
        padded = [fn.padded_launches for fn in publics]
        out, got_lse = torch_fa.flash_attention_fwd(q, k, k,
                                                    return_residuals=True)
        dq = torch_fa.flash_attention_bwd_dq(q, k, k, q, lse, lse)
        dk, dv = torch_fa.flash_attention_bwd_dkv(q, k, k, q, lse, lse)
        assert calls == [
            (f'skytpu_flash_attention_{kernel}_f32',
             getattr(torch_fa, f'flash_attention_{kernel}_f32'), width,
             torch.float32, d**-0.5)
            for kernel in ('fwd', 'bwd_dq', 'bwd_dkv')], d
        calls.clear()
        assert out.shape == dq.shape == q.shape, d
        assert dk.shape == dv.shape == k.shape and got_lse.shape == (1, 2, 4)
        assert [fn.padded_launches - n for fn, n in zip(publics, padded)] == (
            [int(width != d)] * 3), d
    q = torch.zeros(1, 2, 4, 64)
    lse = torch.zeros(1, 2, 4)
    for bad, match in ((q.double(), 'bf16/fp16/f32, got torch.float64'),
                       (torch.zeros(1, 2, 4, 257), 'head_dim 257 is past')):
        for call in (lambda: torch_fa.flash_attention_fwd(bad, bad, bad),
                     lambda: torch_fa.flash_attention_bwd_dq(
                         bad, bad, bad, bad, lse, lse),
                     lambda: torch_fa.flash_attention_bwd_dkv(
                         bad, bad, bad, bad, lse, lse)):
            with pytest.raises(ValueError, match=match):
                call()
    with pytest.raises(ValueError, match='is torch.bfloat16, q is'):
        torch_fa.flash_attention_fwd(q, q.to(torch.bfloat16), q)
    with pytest.raises(ValueError, match='takes bf16/fp16, got'):
        torch_fa.flash_attention_fwd_wide(*[torch.zeros(1, 2, 4, 96)] * 3)
    with pytest.raises(ValueError, match='takes f32, got'):
        torch_fa.flash_attention_fwd_f32(*[q.to(torch.bfloat16)] * 3)
    with pytest.raises(ValueError, match='head_dim 48 not in'):
        torch_fa.flash_attention_bwd_dkv_f32(*[torch.zeros(1, 2, 4, 48)] * 4,
                                             lse, lse)
    assert not calls
    for kernel in ('fwd', 'bwd_dq', 'bwd_dkv'):
        assert torch_fa._SIGNATURES[f'skytpu_flash_attention_{kernel}_f32'] \
            == torch_fa._SIGNATURES[f'skytpu_flash_attention_{kernel}']
        for suffix in ('_f32', '_f32_wide'):
            assert (torch_fa.CSRC_DIR /
                    f'flash_attention_{kernel}{suffix}.cu') in (
                        torch_fa.sources())


# Zero columns add nothing to Q K^T or to dO V^T: the plain versions on q,
# k, v and dO zero-padded to the kernel width, with the real head_dim's
# scale, give the unpadded call's out, lse and gradients (f32 on both
# sides: the einsums may sum in another order) and zero in the padding;
# with the padded width's own scale they give another function.
PAD_ATOL = 1e-5


@pytest.mark.parametrize('d,causal', [(8, True), (24, False), (48, True),
                                      (72, False), (100, True),
                                      (160, False), (200, True)])
def test_zero_padding_to_the_kernel_width_is_the_same_function(d, causal):
    width = torch_fa.kernel_width(d)
    assert width > d
    q, k, v = _t(*_qkv(b=2, h=4, s=32, d=d, hkv=2, seed=8))
    g = torch.from_numpy(np.random.default_rng(9).standard_normal(
        q.shape).astype(np.float32))
    qp, kp, vp, gp = torch_fa._pad_head_dim(width, q, k, v, g)
    assert qp.shape == (2, 4, 32, width) and kp.shape == (2, 2, 32, width)
    assert not qp[..., d:].any() and torch.equal(gp[..., :d], g)
    out, lse = torch_fa.flash_attention_fwd_reference(
        q, k, v, causal=causal, return_residuals=True)
    delta = torch_fa._delta(out, g)
    want = (out, lse,
            torch_fa.flash_attention_bwd_dq_reference(q, k, v, g, lse, delta,
                                                      causal),
            *torch_fa.flash_attention_bwd_dkv_reference(q, k, v, g, lse,
                                                        delta, causal))
    for scale, same in ((d**-0.5, True), (None, False)):
        out_p, lse_p = torch_fa.flash_attention_fwd_reference(
            qp, kp, vp, causal=causal, return_residuals=True, scale=scale)
        got = (out_p, lse_p,
               torch_fa.flash_attention_bwd_dq_reference(
                   qp, kp, vp, gp, lse_p, delta, causal, scale=scale),
               *torch_fa.flash_attention_bwd_dkv_reference(
                   qp, kp, vp, gp, lse_p, delta, causal, scale=scale))
        for name, x, ref in zip(('out', 'lse', 'dq', 'dk', 'dv'), got, want):
            if name != 'lse':
                assert not x[..., d:].any(), name
                x = x[..., :d]
            if same:
                torch.testing.assert_close(x, ref, atol=PAD_ATOL, rtol=0,
                                           msg=name)
            elif name in ('out', 'lse'):
                assert (x - ref).abs().max() > 1e-2, name


def test_flash_fwd_block_contract_and_devices():
    q, k, v = _qkv(b=1, h=2, s=600, d=64)
    with pytest.raises(ValueError, match='must divide block size'):
        jax_fa.flash_attention_fwd(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), interpret=True)
    with pytest.raises(ValueError, match='must divide block size'):
        torch_fa.flash_attention_fwd(*_t(q, k, v))
    # S < block: the block shrinks to S, as in the Pallas wrapper.
    q, k, v = _qkv(b=1, h=2, s=48, d=64)
    out = torch_fa.flash_attention_fwd(*_t(q, k, v))
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jax_attn.mha_reference(q, k, v)),
        atol=FLASH_ATOL, rtol=0)
    # Neither CPU nor CUDA: refused, never computed on the side.
    with pytest.raises(ValueError, match='CPU or CUDA'):
        torch_fa.flash_attention_fwd(*[t.to('meta') for t in _t(q, k, v)])


@pytest.mark.parametrize('causal,hkv', [(True, None), (False, None),
                                        (True, 2)])
def test_flash_bwd_plain_matches_pallas_interpret(causal, hkv):
    """The JAX backward's own shapes and tolerance (tests/test_ops.py):
    (1, 2, 256, 64) causal and not, GQA (1, 4 -> 2, 256, 64)."""
    h = 4 if hkv else 2
    q, k, v = _qkv(b=1, h=h, s=256, d=64, hkv=hkv, seed=1)
    g = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    out, lse = jax_fa.flash_attention_fwd(q, k, v, causal=causal,
                                          block_size=128, interpret=True,
                                          return_residuals=True)
    want = jax_fa.flash_attention_bwd(q, k, v, out, lse, g, causal=causal,
                                      block_size=128, interpret=True)
    before = (torch_fa.flash_attention_bwd_dq.launches,
              torch_fa.flash_attention_bwd_dkv.launches)
    got = torch_fa.flash_attention_bwd(
        *_t(q, k, v, np.asarray(out), np.asarray(lse), g), causal=causal,
        block_size=128)
    assert (torch_fa.flash_attention_bwd_dq.launches,
            torch_fa.flash_attention_bwd_dkv.launches) == before
    for name, x, ref in zip(('dq', 'dk', 'dv'), got, want):
        assert x.shape == ref.shape and x.dtype == torch.float32, name
        np.testing.assert_allclose(x.numpy(), np.asarray(ref),
                                   atol=FLASH_ATOL, rtol=0, err_msg=name)


# The `tiny` configs train at head_dim 16: the backward's small kernels'
# plain versions (what CPU tensors take, through both the public wrappers
# and the small ones) against the Pallas backward in interpret mode, GQA
# 4 -> 2.  Each S with both head dims, each head dim causal and not; then
# the wide kernels' head dims (80, 96, 256) and head dims that take the
# zero-padded route (8, 48, 100); and 128, the f32 width the others do not
# cover.
@pytest.mark.parametrize('s,d,causal', [
    (8, 16, True), (8, 32, False), (16, 16, False), (16, 32, True),
    (64, 16, True), (64, 32, False), (128, 16, False), (128, 32, True),
    (16, 8, True), (64, 48, False), (64, 80, True), (16, 96, False),
    (128, 96, True), (64, 100, True), (16, 256, True), (64, 256, False),
    (64, 128, True), (16, 128, False)])
def test_flash_bwd_small_head_dims_plain_match_pallas_interpret(s, d,
                                                                causal):
    q, k, v = _qkv(b=2, h=4, s=s, d=d, hkv=2, seed=6)
    g = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)
    # Both backwards take the same residuals (the forward's parity is
    # test_flash_fwd_small_head_dims_plain_match_pallas_interpret's).
    out, lse = (x.numpy() for x in torch_fa.flash_attention_fwd_reference(
        *_t(q, k, v), causal=causal, return_residuals=True))
    want = jax_fa.flash_attention_bwd(q, k, v, out, lse, g, causal=causal,
                                      interpret=True)
    args = _t(q, k, v, g, lse)
    names = ('flash_attention_bwd_dq', 'flash_attention_bwd_dkv',
             'flash_attention_bwd_dq_small', 'flash_attention_bwd_dkv_small',
             'flash_attention_bwd_dq_wide', 'flash_attention_bwd_dkv_wide',
             'flash_attention_bwd_dq_256', 'flash_attention_bwd_dkv_256')
    before = [getattr(torch_fa, name).launches for name in names]
    got = torch_fa.flash_attention_bwd(*_t(q, k, v, out, lse, g),
                                       causal=causal)
    delta = torch_fa._delta(torch.from_numpy(out), args[3])
    for suffix in ('_small', '_wide', '_256'):
        route = (getattr(torch_fa, f'flash_attention_bwd_dq{suffix}')(
            *args, delta, causal),
                 *getattr(torch_fa, f'flash_attention_bwd_dkv{suffix}')(
                     *args, delta, causal))
        for name, x, y in zip(('dq', 'dk', 'dv'), got, route):
            torch.testing.assert_close(y, x, atol=0, rtol=0, msg=name)
    assert [getattr(torch_fa, name).launches for name in names] == before
    for name, x, ref in zip(('dq', 'dk', 'dv'), got, want):
        assert x.shape == ref.shape and x.dtype == torch.float32, name
        np.testing.assert_allclose(x.numpy(), np.asarray(ref),
                                   atol=FLASH_ATOL, rtol=0, err_msg=name)


# The dk/dv kernel at 256 cuts each kv tile's (query head, q tile) steps
# into `split` ranges when its grid alone would not fill the card: at
# Gemma-2B's causal shapes (8 query heads over 1 kv head) it splits, 2 at
# 2 x 4096 and 4 at the serving bucket's 8 x 256 (the splits an H100
# measured fastest there); Gemma-7B's 2048 CTAs (16 kv heads) and
# bench-1b-like GQA take none.  The split is a power of two, no finer than
# tile 0's steps, and the least time it leaves (heaviest range, or steps
# over the SMs its grid fills) is within DKV_256_SLACK of the card's
# share unless the split is at its cap.  Each tile's ranges cover its
# steps once, in order, within one step of each other.
def _dkv_256_ranges(n_steps, split):
    """The dk/dv kernel's cut of a kv tile's `n_steps` (query head, q
    tile) steps into `split` ranges [lo, hi), as
    csrc/flash_attention_bwd_dkv_256.cu forms them (it_lo, n_iters)."""
    return [(n_steps * c // split, n_steps * (c + 1) // split)
            for c in range(split)]


@pytest.mark.parametrize('b,hq,hkv,s,causal,want_split', [
    (2, 8, 1, 4096, True, 2), (8, 8, 1, 256, True, 4),
    (2, 8, 1, 4096, False, 1), (8, 8, 1, 256, False, 2),
    (2, 16, 16, 4096, True, 1), (8, 16, 16, 256, True, 1),
    (2, 16, 16, 4096, False, 1), (4, 16, 8, 4096, True, 1),
    (2, 8, 2, 17, False, None), (1, 8, 1, 1000, True, None),
    (2, 4, 4, 1, True, 1), (1, 8, 2, 65, True, None)])
def test_dkv_256_split_plan_fills_the_card(b, hq, hkv, s, causal,
                                           want_split):
    sms = torch_fa.H100_SMS
    split = torch_fa.plan_dkv_256_split(b, hq, hkv, s, causal, sms)
    n_tiles = -(-s // torch_fa.DKV_256_BLOCK)
    steps = [hq // hkv * (n_tiles - (j if causal else 0))
             for j in range(n_tiles)]
    total = b * hkv * sum(steps)
    share = -(-total // sms)
    assert 1 <= split <= torch_fa.DKV_256_MAX_SPLIT
    assert split & (split - 1) == 0 and split <= max(steps)
    if want_split is not None:
        assert split == want_split
    heaviest = max(hi - lo for lo, hi in _dkv_256_ranges(steps[0],
                                                                 split))
    grid = b * hkv * n_tiles * split
    least = max(heaviest, -(-total // min(sms, grid)))
    assert (least <= torch_fa.DKV_256_SLACK * share or
            split == torch_fa.DKV_256_MAX_SPLIT or 2 * split > steps[0])
    for n in steps:
        ranges = _dkv_256_ranges(n, split)
        assert len(ranges) == split and ranges[0][0] == 0
        assert ranges[-1][1] == n
        assert all(a[1] == b_[0] for a, b_ in zip(ranges, ranges[1:]))
        sizes = [hi - lo for lo, hi in ranges]
        assert min(sizes) >= 0 and max(sizes) - min(sizes) <= 1


# On CPU tensors the wgmma kernels' wrappers at 256 take the plain
# versions: bit for bit the `_reference` functions, no launch counted.
@pytest.mark.parametrize('hq,hkv', [(4, 4), (8, 1)])
@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('with_lse', [True, False])
def test_fwd_256_wrapper_takes_the_plain_version_on_cpu(hq, hkv, causal,
                                                        with_lse):
    q, k, v = (t.to(torch.bfloat16) for t in _t(*_qkv(
        b=1, h=hq, s=65, d=256, hkv=hkv, seed=11)))
    before = torch_fa.flash_attention_fwd_256.launches
    got = torch_fa.flash_attention_fwd_256(q, k, v, causal=causal,
                                           return_residuals=with_lse)
    want = torch_fa.flash_attention_fwd_reference(
        q, k, v, causal=causal, return_residuals=with_lse)
    assert torch_fa.flash_attention_fwd_256.launches == before == 0
    got, want = ((x,) if not with_lse else x for x in (got, want))
    assert len(got) == len(want) == (2 if with_lse else 1)
    assert got[0].dtype == torch.bfloat16 and got[0].shape == q.shape
    for x, ref in zip(got, want):
        torch.testing.assert_close(x, ref, atol=0, rtol=0)


@pytest.mark.parametrize('hq,hkv,causal', [(4, 4, True), (8, 1, False),
                                           (8, 1, True), (4, 2, False)])
def test_bwd_256_wrappers_take_the_plain_version_on_cpu(hq, hkv, causal):
    q, k, v = _qkv(b=1, h=hq, s=65, d=256, hkv=hkv, seed=9)
    g = np.random.default_rng(10).standard_normal(q.shape).astype(np.float32)
    q, k, v, g = (t.to(torch.bfloat16) for t in _t(q, k, v, g))
    out, lse = torch_fa.flash_attention_fwd_reference(
        q, k, v, causal=causal, return_residuals=True)
    delta = torch_fa._delta(out, g)
    before = (torch_fa.flash_attention_bwd_dq_256.launches,
              torch_fa.flash_attention_bwd_dkv_256.launches)
    dq = torch_fa.flash_attention_bwd_dq_256(q, k, v, g, lse, delta, causal)
    dk, dv = torch_fa.flash_attention_bwd_dkv_256(q, k, v, g, lse, delta,
                                                  causal)
    assert (torch_fa.flash_attention_bwd_dq_256.launches,
            torch_fa.flash_attention_bwd_dkv_256.launches) == before
    want = (torch_fa.flash_attention_bwd_dq_reference(q, k, v, g, lse, delta,
                                                      causal),
            *torch_fa.flash_attention_bwd_dkv_reference(q, k, v, g, lse,
                                                        delta, causal))
    for name, x, ref in zip(('dq', 'dk', 'dv'), (dq, dk, dv), want):
        assert x.dtype == torch.bfloat16 and x.shape == ref.shape, name
        torch.testing.assert_close(x, ref, atol=0, rtol=0, msg=name)


def test_flash_bwd_contract():
    q, k, v = _t(*_qkv(b=1, h=2, s=600, d=64))
    lse = torch.zeros(1, 2, 600)
    with pytest.raises(ValueError, match='must divide block size'):
        torch_fa.flash_attention_bwd(q, k, v, q, lse, q)
    q, k, v = _t(*_qkv(b=1, h=2, s=64, d=64))
    lse = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError, match='CPU or CUDA'):
        torch_fa.flash_attention_bwd(
            *[t.to('meta') for t in (q, k, v, q, lse, q)])


# Autograd through the op vs autograd through mha_reference, both f32:
# summation order only (-1e30 vs -inf masking changes nothing visible).
GRAD_ATOL = 1e-4


@pytest.mark.parametrize('causal,hkv,s', [(True, None, 64), (False, None, 64),
                                          (True, 2, 96)])
def test_flash_attention_autograd_matches_mha_reference(causal, hkv, s):
    q, k, v = _qkv(b=2, h=4, s=s, d=32, hkv=hkv, seed=3)
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(
        q.shape).astype(np.float32))
    results = []
    for fn in (torch_attn.flash_attention, torch_attn.mha_reference):
        leaves = [t.requires_grad_() for t in _t(q, k, v)]
        out = fn(*leaves, causal=causal)
        results.append((out.detach(), *torch.autograd.grad(out, leaves, g)))
    for name, got, want in zip(('out', 'dq', 'dk', 'dv'), *results):
        torch.testing.assert_close(got, want, atol=GRAD_ATOL, rtol=0,
                                   msg=name)
    # Without an input that needs a gradient, nothing is saved or built.
    with torch.no_grad():
        assert torch_attn.flash_attention(*_t(q, k, v)).grad_fn is None


def test_library_name_covers_headers(tmp_path):
    """The kernel library's name digests every source and shared header:
    an edited header (or source) gives a new name, so a stale build is
    never loaded; nvcc still compiles only the sources."""
    src = tmp_path / 'kernel.cu'
    header = tmp_path / 'common.cuh'
    src.write_text('#include "common.cuh"\n')
    header.write_text('// v1\n')
    first = torch_fa.library_name(tmp_path)
    assert first == torch_fa.library_name(tmp_path)
    header.write_text('// v2\n')
    second = torch_fa.library_name(tmp_path)
    assert second != first
    src.write_text('#include "common.cuh"\n// edited\n')
    assert torch_fa.library_name(tmp_path) not in (first, second)
    assert (torch_fa.CSRC_DIR / 'sm90_common.cuh').exists()
    assert torch_fa.sources() and all(p.suffix == '.cu'
                                      for p in torch_fa.sources())


_C_KINDS = {ctypes.c_void_p: 'pointer', ctypes.c_int: 'int',
            ctypes.c_float: 'float'}


def _c_kind(param: str) -> str:
    if '*' in param:
        return 'pointer'
    return {'int': 'int', 'float': 'float'}[param.split()[-2]]


def test_c_entry_points_match_ctypes_signatures():
    """Every `extern "C" int skytpu_...(` in csrc/ has the parameter count
    and pointer/int/float kinds its ctypes argtypes declare: a mistyped
    pointer would be cut to 32 bits without a word."""
    declared = {}
    for src in torch_fa.sources():
        for name, params in re.findall(
                r'extern "C" int (skytpu_\w+)\(([^)]*)\)', src.read_text()):
            assert name not in declared, name
            declared[name] = [_c_kind(p) for p in params.split(',')]
    assert set(declared) == set(torch_fa._SIGNATURES)
    for name, argtypes in torch_fa._SIGNATURES.items():
        assert declared[name] == [_C_KINDS[a] for a in argtypes], name


def test_jax_stays_on_cpu():
    assert jax.default_backend() == 'cpu'
