"""Hand-written Hopper flash-attention kernels, bound with ctypes.

PyTorch/CUDA counterparts of `skypilot_tpu/ops/pallas/flash_attention.py`:

- `flash_attention_fwd` (the Pallas `_fa_kernel`): q [B, Hq, S, D], k/v
  [B, Hkv, S, D] -> out [B, Hq, S, D] in q's dtype and, with
  `return_residuals=True`, the row logsumexp [B, Hq, S] f32 (+inf for
  all-masked rows).  Source `csrc/flash_attention_fwd.cu` (wgmma, a TMA
  ring of K/V stages, the softmax in registers) at head_dim 64 and 128.
- `flash_attention_bwd` (the Pallas `flash_attention_bwd`): the same
  contract minus `interpret`; delta = rowsum(dO * O) in PyTorch, then
  `flash_attention_bwd_dq` (`_fa_bwd_dq_kernel`; source
  `csrc/flash_attention_bwd_dq.cu`, wgmma, a TMA ring of K/V stages, dS
  in registers) and `flash_attention_bwd_dkv` (`_fa_bwd_dkv_kernel`,
  dk/dv already summed to Hkv heads; source
  `csrc/flash_attention_bwd_dkv.cu`, wgmma with P^T and dS^T in
  registers), at head_dim 64 and 128.

The three kernels at head_dim 256 in bf16 and fp16 are wgmma kernels of
their own (`csrc/flash_attention_fwd_256.cu`, 64-row K/V stages under a
128-row q tile, 64 q rows a consumer warpgroup;
`csrc/flash_attention_bwd_dq_256.cu`, 32-row K/V stages under a 128-row
q tile; `csrc/flash_attention_bwd_dkv_256.cu`, two consumer warpgroups,
one computing S^T and dV, the other dP^T and dK, and a grid split over
each kv tile's query work, `plan_dkv_256_split`, with f32 partials
summed in a fixed order by a second kernel; the wrappers
`flash_attention_fwd_256`, `flash_attention_bwd_dq_256`,
`flash_attention_bwd_dkv_256`).  The same three kernels in mma.sync (K/V
or Q/dO tiles by cp.async; templates in
`csrc/flash_attention_{fwd,bwd_dq,bwd_dkv}_mma.cuh`) take what the wgmma
kernels' 64-element 16-bit swizzled rows do not: bf16 and fp16 at 16
and 32 (m16n8k16; `csrc/*_small.cu`, the wrappers
`flash_attention_fwd_small`, `flash_attention_bwd_dq_small`,
`flash_attention_bwd_dkv_small`) and 80 and 96 (`csrc/*_wide.cu`, the
`*_wide` wrappers), and f32 at every width, 16, 32, 64, 80, 96, 128
and 256 (m16n8k8 tf32 taken three times, 3xTF32: each operand split into
tf32 hi and lo parts, f32-class error; `csrc/*_f32.cu` and
`csrc/*_f32_wide.cu`, the `*_f32` wrappers).  The public wrappers route
by kernel, dtype and head_dim (`kernel_width`, the same widths in every
dtype; `_ROUTE_SUFFIX`): f32 goes to the f32 kernels, bf16
and fp16 to the others; a kernel
width goes to its kernel; any other head_dim up to 256 is zero-padded
in q, k, v (and dO) to the smallest wider width, runs that width's
kernel with the real head_dim^-1/2 as its scale (zero columns add
nothing to Q K^T or dO V^T, so out, lse and the gradients are the same
function), and out, dq, dk and dv are sliced back; past 256 the call is
refused, and so is any other dtype (f64 included) or a mix of dtypes.
Nothing is cast: f32 never runs as bf16.  The padded route is no
fallback: no route is tried after another fails.  Each launch counts on
the `.launches` of the wrapper of the kernel that ran; each padded call
also on the public wrapper's `.padded_launches`.  The per-route wrappers
(`*_small`, `*_wide`, `*_256`, `*_f32`) are built by `_route_wrapper`
from one table of routes.  The Hopper building blocks the
three wgmma kernels share are in `csrc/sm90_common.cuh`; the mma.sync
ones in `csrc/sm80_mma.cuh`.

GQA reads kv head h // (Hq // Hkv) inside the kernels.  Every source in
`csrc/` is compiled with nvcc for sm_90a (one process per source, in
parallel) and linked into one shared library with a plain C interface,
named by a hash of all sources, headers and flags, at first use, under
`build/skypilot_tpu_torch/` beside the package (the repo's `build/` when
the package runs from the tree; an installed package carries `csrc/` as
package data); kernels launch on PyTorch's current stream.
`block_size` keeps the TPU wrappers' contract (S must divide
min(block_size, S)); the CUDA kernels pick their own tiles and mask the
ragged edge themselves.

The library's build is the one `nvcc` site of the port: it runs inside
`perf.compile_telemetry.compiling('kernel_build', ...)`, so it counts as
a compile and, after the recompile sentinel is armed, as a hazard.

CPU tensors take each kernel's plain PyTorch version (`*_reference`); a
CUDA tensor always launches the kernel or raises.  Each kernel's wrapper
counts its launches in `.launches`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import List, Optional, Tuple

import torch

from skypilot_tpu_torch.perf import compile_telemetry

_NEG_INF = -1e30
_PKG_DIR = pathlib.Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / 'csrc'
BUILD_DIR = _PKG_DIR.parent / 'build' / 'skypilot_tpu_torch'
ARCH_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a')
COMPILE_FLAGS = ARCH_FLAGS + ('-std=c++17', '-O3', '-Xcompiler', '-fPIC',
                              '-Xptxas', '-v', '-c')
LINK_FLAGS = ARCH_FLAGS + ('-shared',)
_DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
_HALF_DTYPES = (torch.bfloat16, torch.float16)
_F32_DTYPES = (torch.float32,)
# bf16/fp16 head dims of the wgmma kernels (forward, dq, dk/dv) at 64 and
# 128 and at 256, and of the mma.sync ones (the same three) at the small
# and at the wide widths; f32 (the mma.sync kernels in 3xTF32) takes every
# one of these widths.  Every other head_dim up to the widest is
# zero-padded to the next width.
_HEAD_DIMS = (64, 128)
_SMALL_HEAD_DIMS = (16, 32)
_WIDE_HEAD_DIMS = (80, 96)
KERNEL_WIDTHS = tuple(sorted(_HEAD_DIMS + _SMALL_HEAD_DIMS + _WIDE_HEAD_DIMS
                             + (256,)))
MAX_HEAD_DIM = KERNEL_WIDTHS[-1]
KERNELS = ('fwd', 'bwd_dq', 'bwd_dkv')
# The suffix of the three kernels' bf16/fp16 C entries and wrappers at
# each width (every f32 width's is '_f32').
_ROUTE_SUFFIX = {**dict.fromkeys(_HEAD_DIMS, ''),
                 **dict.fromkeys(_SMALL_HEAD_DIMS, '_small'),
                 **dict.fromkeys(_WIDE_HEAD_DIMS, '_wide'), 256: '_256'}
_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes.
_SIGNATURES = {
    'skytpu_flash_attention_fwd':
        [_P] * 5 + [_I] * 6 + [ctypes.c_float, _I, _P],
    'skytpu_flash_attention_fwd_small':
        [_P] * 5 + [_I] * 6 + [ctypes.c_float, _I, _P],
    'skytpu_flash_attention_fwd_wide':
        [_P] * 5 + [_I] * 6 + [ctypes.c_float, _I, _P],
    'skytpu_flash_attention_fwd_f32':
        [_P] * 5 + [_I] * 6 + [ctypes.c_float, _I, _P],
    'skytpu_flash_attention_fwd_256':
        [_P] * 5 + [_I] * 6 + [ctypes.c_float, _I, _P],
    'skytpu_flash_attention_bwd_dq':
        [_P] * 7 + [_I] * 6 + [ctypes.c_float, _I, _P],
    'skytpu_flash_attention_bwd_dq_small':
        [_P] * 7 + [_I] * 6 + [ctypes.c_float, _I, _P],
    'skytpu_flash_attention_bwd_dq_wide':
        [_P] * 7 + [_I] * 6 + [ctypes.c_float, _I, _P],
    'skytpu_flash_attention_bwd_dq_f32':
        [_P] * 7 + [_I] * 6 + [ctypes.c_float, _I, _P],
    'skytpu_flash_attention_bwd_dq_256':
        [_P] * 7 + [_I] * 6 + [ctypes.c_float, _I, _P],
    'skytpu_flash_attention_bwd_dkv':
        [_P] * 8 + [_I] * 6 + [ctypes.c_float, _I, _P],
    'skytpu_flash_attention_bwd_dkv_small':
        [_P] * 8 + [_I] * 6 + [ctypes.c_float, _I, _P],
    'skytpu_flash_attention_bwd_dkv_wide':
        [_P] * 8 + [_I] * 6 + [ctypes.c_float, _I, _P],
    'skytpu_flash_attention_bwd_dkv_f32':
        [_P] * 8 + [_I] * 6 + [ctypes.c_float, _I, _P],
    # The dk/dv entries' arguments, then the split's f32 workspace and
    # count (plan_dkv_256_split), then the stream.
    'skytpu_flash_attention_bwd_dkv_256':
        [_P] * 8 + [_I] * 6 + [ctypes.c_float, _I, _P, _I, _P],
}
# The dk/dv kernel at 256 (csrc/flash_attention_bwd_dkv_256.cu): k rows a
# CTA (and q rows a step), and the most ranges the host cuts a kv tile's
# query work into.
DKV_256_BLOCK = 64
DKV_256_MAX_SPLIT = 16
# How far above the card's share of the steps a split's least time may
# stay before the planner doubles it (plan_dkv_256_split).
DKV_256_SLACK = 2
# Streaming multiprocessors of an H100 SXM: the planner's default (a
# launch asks the card).
H100_SMS = 132


def sources() -> List[pathlib.Path]:
    """The files nvcc compiles, one process each."""
    return sorted(CSRC_DIR.glob('*.cu'))


def library_name(csrc_dir: pathlib.Path = CSRC_DIR) -> str:
    """File name of the library built from `csrc_dir`: a digest of every
    source and header there (name and bytes) and of the compile and link
    flags, so an edited header rebuilds too."""
    digest = hashlib.sha256(' '.join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for path in sorted([*csrc_dir.glob('*.cu'), *csrc_dir.glob('*.cuh')]):
        digest.update(path.name.encode() + b'\0' + path.read_bytes())
    return f'libskytpu_kernels-{digest.hexdigest()[:16]}.so'


class _Library:
    """The compiled kernel library: built once per process (content-
    addressed on disk over every source, header and flag, so an edited
    file never loads a stale binary)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.build_log = ''

    def _nvcc(self) -> str:
        cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
        nvcc = shutil.which('nvcc') or os.path.join(cuda_home, 'bin', 'nvcc')
        if not os.path.exists(nvcc):
            raise RuntimeError(
                f'nvcc not found (PATH or {cuda_home}/bin): the flash-'
                f'attention kernels are compiled on the machine with the GPU')
        return nvcc

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = self._build_and_load()
            return self._lib

    def _build_and_load(self) -> ctypes.CDLL:
        srcs = sources()
        out = BUILD_DIR / library_name()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # Build in a private directory, then rename the library: a
            # concurrent build in another process never loads a
            # half-written file.
            shapes = (f'nvcc sm_90a: {", ".join(p.name for p in srcs)} -> '
                      f'{out.name}')
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp, \
                    compile_telemetry.compiling('kernel_build', shapes):
                self.build_log = self._compile_and_link(
                    srcs, pathlib.Path(tmp), out)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        return lib

    def _compile_and_link(self, srcs, tmp: pathlib.Path,
                          out: pathlib.Path) -> str:
        nvcc = self._nvcc()
        objs = [tmp / f'{src.stem}.o' for src in srcs]
        procs = [subprocess.Popen([nvcc, *COMPILE_FLAGS, '-o', str(obj),
                                   str(src)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(srcs, objs)]
        logs, failed = [], []
        for src, proc in zip(srcs, procs):
            text, _ = proc.communicate()
            logs.append(f'== {src.name}\n{text}')
            if proc.returncode != 0:
                failed.append(src.name)
        log = ''.join(logs)
        if failed:
            raise RuntimeError(f'nvcc failed on {failed}:\n{log}')
        lib_tmp = tmp / out.name
        proc = subprocess.run(
            [nvcc, *LINK_FLAGS, '-o', str(lib_tmp), *map(str, objs)],
            capture_output=True, text=True, check=False)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc link failed ({proc.returncode}):\n{log}')
        os.replace(lib_tmp, out)
        return log


_LIBRARY = _Library()


def build() -> str:
    """Compile (if needed) and load the kernel library; returns nvcc's
    output of this process's build, per source (ptxas registers, shared
    memory and spills), empty when an earlier build was reused."""
    _LIBRARY.get()
    return _LIBRARY.build_log


def _check_block(s: int, block_size: int) -> None:
    block = min(block_size, s)
    if s % block:
        raise ValueError(f'seq len {s} must divide block size {block}')


def _device_type(*tensors: torch.Tensor) -> str:
    """'cpu' or 'cuda' when every tensor lies there; raises otherwise."""
    devices = {t.device.type for t in tensors}
    if devices in ({'cpu'}, {'cuda'}):
        return devices.pop()
    raise ValueError(f'the flash-attention kernels take CPU or CUDA tensors '
                     f'(all on one), got {sorted(devices)}')


def _check_cuda_inputs(q, k, v, *same_as_q, head_dims=None,
                       dtypes=tuple(_DTYPE_CODES)) -> None:
    """q and same_as_q [B,Hq,S,D], k/v [B,Hkv,S,D]: one device and one
    dtype of `dtypes` (the public wrappers': bf16, fp16 or f32), head_dim
    in `head_dims` (any with None: the public wrappers' `kernel_width`
    refuses past MAX_HEAD_DIM), contiguous and 16-byte aligned."""
    b, hq, s, d = q.shape
    for name, t in (('q', q), ('k', k), ('v', v),
                    *((f'arg{i}', t) for i, t in enumerate(same_as_q))):
        if t.device != q.device:
            raise ValueError(f'{name} is on {t.device}, q on {q.device}')
        if t.dtype != q.dtype:
            raise ValueError(f'{name} is {t.dtype}, q is {q.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
        if t.data_ptr() % 16:
            raise ValueError(f'{name} must be 16-byte aligned')
    if q.dtype not in dtypes:
        names = {torch.bfloat16: 'bf16', torch.float16: 'fp16',
                 torch.float32: 'f32'}
        raise ValueError(f'this flash-attention kernel takes '
                         f'{"/".join(names[t] for t in dtypes)}, got '
                         f'{q.dtype}')
    if head_dims is not None and d not in head_dims:
        raise ValueError(f'head_dim {d} not in {head_dims}: the kernel '
                         f'takes head_dim {", ".join(map(str, head_dims))}')
    if (k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or
            k.shape[2] != s or k.shape[3] != d or hq % k.shape[1] or
            any(t.shape != q.shape for t in same_as_q)):
        raise ValueError(f'bad shapes q {tuple(q.shape)} k {tuple(k.shape)} '
                         f'v {tuple(v.shape)} '
                         f'{[tuple(t.shape) for t in same_as_q]}')


def _check_rows(q, *rows) -> None:
    """Per-row f32 inputs (lse, delta) [B, Hq, S] on q's device."""
    for t in rows:
        if (t.dtype != torch.float32 or t.shape != q.shape[:3] or
                t.device != q.device or not t.is_contiguous()):
            raise ValueError(f'per-row inputs must be contiguous f32 '
                             f'{tuple(q.shape[:3])} on {q.device}, got '
                             f'{t.dtype} {tuple(t.shape)} on {t.device}')


def kernel_width(head_dim: int) -> int:
    """The kernel width a CUDA call at `head_dim` runs (in any dtype):
    head_dim itself where a kernel takes it, else the smallest wider one
    (the wrappers zero-pad to it); refused past MAX_HEAD_DIM."""
    for width in KERNEL_WIDTHS:
        if head_dim <= width:
            return width
    raise ValueError(f'head_dim {head_dim} is past {MAX_HEAD_DIM}, the '
                     f'widest flash-attention kernel: the kernels take '
                     f'head_dim 1 to {MAX_HEAD_DIM}')


def _route(kernel: str, width: int, dtype: torch.dtype):
    """(C entry, the wrapper that counts its launches) of `kernel` ('fwd',
    'bwd_dq' or 'bwd_dkv') at a kernel width of `dtype`."""
    suffix = '_f32' if dtype == torch.float32 else _ROUTE_SUFFIX[width]
    name = f'flash_attention_{kernel}{suffix}'
    return f'skytpu_{name}', globals()[name]


def _pad_head_dim(width: int, *tensors: torch.Tensor) -> List[torch.Tensor]:
    """Each [..., D] tensor zero-padded to [..., width] (a new contiguous
    tensor)."""
    return [torch.nn.functional.pad(t, (0, width - t.shape[-1]))
            for t in tensors]


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f'{name} kernel launch failed: cudaError {err}')


# ----- forward ----------------------------------------------------------------


def flash_attention_fwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, causal: bool = True,
                                  return_residuals: bool = False,
                                  scale: Optional[float] = None):
    """Plain PyTorch version of the kernel's function, in f32: -1e30
    masking, 0 output and +inf lse for rows whose denominator is 0, then
    out cast to q's dtype.  `scale` is the C entries' (head_dim^-1/2 when
    None)."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    logits = torch.einsum('bhqd,bhkd->bhqk', q.float(), kf) * (
        d**-0.5 if scale is None else scale)
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, _NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (torch.einsum('bhqk,bhkd->bhqd', p, vf) / safe_l).to(q.dtype)
    if not return_residuals:
        return out
    lse = torch.where(l == 0.0, torch.full_like(l, float('inf')),
                      m + torch.log(safe_l))
    return out, lse[..., 0]


def flash_attention_fwd(q: torch.Tensor,
                        k: torch.Tensor,
                        v: torch.Tensor,
                        causal: bool = True,
                        block_size: int = 512,
                        return_residuals: bool = False):
    """q [B,Hq,S,D], k/v [B,Hkv,S,D] -> [B,Hq,S,D] (and the row
    logsumexp [B,Hq,S] f32 with `return_residuals=True`).  On a CUDA
    tensor the kernel of `kernel_width(D)` runs (f32: the `_f32` kernel
    of that width), on q, k, v zero-padded to that width where it is
    wider than D."""
    if q.dim() != 4:
        raise ValueError(f'q must be [B, H, S, D], got {tuple(q.shape)}')
    _check_block(q.shape[2], block_size)
    if _device_type(q, k, v) == 'cpu':
        return flash_attention_fwd_reference(
            q, k, v, causal=causal, return_residuals=return_residuals)
    _check_cuda_inputs(q, k, v)
    d = q.shape[3]
    width = kernel_width(d)
    if width != d:
        q, k, v = _pad_head_dim(width, q, k, v)
        flash_attention_fwd.padded_launches += 1
    result = _launch_fwd(*_route('fwd', width, q.dtype), q, k, v, causal,
                         return_residuals, d**-0.5)
    if width == d:
        return result
    if return_residuals:
        return result[0][..., :d].contiguous(), result[1]
    return result[..., :d].contiguous()


flash_attention_fwd.launches = 0
# Calls on CUDA tensors that took the zero-padded route (their launches
# count on the wrapper of the width that ran).
flash_attention_fwd.padded_launches = 0


def _launch_fwd(entry: str, wrapper, q, k, v, causal, return_residuals,
                scale):
    """Launch a forward kernel through its C entry on checked CUDA inputs
    and count the launch on `wrapper`."""
    b, hq, s, d = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
           if return_residuals else None)
    lib = _LIBRARY.get()
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            b, hq, k.shape[1], s, d, _DTYPE_CODES[q.dtype], scale,
            int(causal), _stream(q.device))
    _raise_on(err, wrapper.__name__)
    wrapper.launches += 1
    return (out, lse) if return_residuals else out




# ----- backward ---------------------------------------------------------------


def _recompute_p_ds(q, k, v, g, lse, delta, causal, scale=None):
    """The backward's recompute in f32 (the Pallas `_recompute_p_ds`):
    P = exp(mask(Q K^T scale) - lse) with -1e30 masking, dS = P (dO V^T -
    delta) scale (head_dim^-1/2 when None), at Hq heads; also returns K
    repeated to Hq heads."""
    hq, s, d = q.shape[1], q.shape[2], q.shape[3]
    group = hq // k.shape[1]
    scale = d**-0.5 if scale is None else scale
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    logits = torch.einsum('bhqd,bhkd->bhqk', q.float(), kf) * scale
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, _NEG_INF)
    p = torch.exp(logits - lse[..., None])
    del logits
    dp = torch.einsum('bhqd,bhkd->bhqk', g.float(), vf)
    ds = p * (dp - delta[..., None]) * scale
    return p, ds, kf


def _group_sum(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """[B, Hq, S, D] -> [B, Hkv, S, D]: sum each kv head's query heads
    (laid out [h0, h0, h1, h1, ...] as repeat_interleave makes them)."""
    b, hq, s, d = x.shape
    return x.view(b, hkv, hq // hkv, s, d).sum(dim=2)


def flash_attention_bwd_dq_reference(q, k, v, g, lse, delta,
                                     causal: bool = True,
                                     scale: Optional[float] = None
                                     ) -> torch.Tensor:
    """Plain version of the dq kernel, in f32: dS rounded to k's dtype
    before dS K (as the TPU kernel's `ds.astype(k.dtype)`); `scale` as
    `flash_attention_fwd_reference`'s."""
    _, ds, kf = _recompute_p_ds(q, k, v, g, lse, delta, causal, scale)
    dq = torch.einsum('bhqk,bhkd->bhqd', ds.to(k.dtype).float(), kf)
    return dq.to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, g, lse, delta,
                                      causal: bool = True,
                                      scale: Optional[float] = None
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dk/dv kernel, in f32: P rounded to dO's dtype
    before P^T dO and dS to q's before dS^T Q (as the TPU kernel does),
    then summed over each kv head's group of query heads; `scale` as
    `flash_attention_fwd_reference`'s."""
    p, ds, _ = _recompute_p_ds(q, k, v, g, lse, delta, causal, scale)
    dv = torch.einsum('bhqk,bhqd->bhkd', p.to(g.dtype).float(), g.float())
    del p
    dk = torch.einsum('bhqk,bhqd->bhkd', ds.to(q.dtype).float(), q.float())
    hkv = k.shape[1]
    return _group_sum(dk, hkv).to(k.dtype), _group_sum(dv, hkv).to(v.dtype)


def _delta(out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) in f32 [B, Hq, S]: the softmax-backward correction,
    computed outside the kernels as the Pallas wrapper computes it in
    XLA."""
    return (g.float() * out.float()).sum(dim=-1)


def flash_attention_bwd_reference(q, k, v, out, lse, g, causal: bool = True):
    """Plain version of `flash_attention_bwd`: (dq, dk, dv)."""
    delta = _delta(out, g)
    dq = flash_attention_bwd_dq_reference(q, k, v, g, lse, delta, causal)
    dk, dv = flash_attention_bwd_dkv_reference(q, k, v, g, lse, delta,
                                               causal)
    return dq, dk, dv


def flash_attention_bwd_dq(q, k, v, g, lse, delta,
                           causal: bool = True) -> torch.Tensor:
    """dq [B,Hq,S,D] from q/g [B,Hq,S,D], k/v [B,Hkv,S,D] and the per-row
    lse, delta [B,Hq,S] f32; on a CUDA tensor routed by
    `kernel_width(D)` as `flash_attention_fwd` is."""
    if _device_type(q, k, v, g, lse, delta) == 'cpu':
        return flash_attention_bwd_dq_reference(q, k, v, g, lse, delta,
                                                causal)
    _check_cuda_inputs(q, k, v, g)
    _check_rows(q, lse, delta)
    d = q.shape[3]
    width = kernel_width(d)
    if width != d:
        q, k, v, g = _pad_head_dim(width, q, k, v, g)
        flash_attention_bwd_dq.padded_launches += 1
    dq = _launch_dq(*_route('bwd_dq', width, q.dtype), q, k, v, g, lse,
                    delta, causal, d**-0.5)
    return dq if width == d else dq[..., :d].contiguous()


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.padded_launches = 0





def _launch_dq(entry: str, wrapper, q, k, v, g, lse, delta, causal, scale):
    """Launch a dq kernel through its C entry on checked CUDA inputs and
    count the launch on `wrapper`."""
    b, hq, s, d = q.shape
    dq = torch.empty_like(q)
    lib = _LIBRARY.get()
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, hq, k.shape[1], s, d, _DTYPE_CODES[q.dtype], scale,
            int(causal), _stream(q.device))
    _raise_on(err, wrapper.__name__)
    wrapper.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B,Hkv,S,D], each summed over its kv head's query heads;
    inputs and routing as `flash_attention_bwd_dq`."""
    if _device_type(q, k, v, g, lse, delta) == 'cpu':
        return flash_attention_bwd_dkv_reference(q, k, v, g, lse, delta,
                                                 causal)
    _check_cuda_inputs(q, k, v, g)
    _check_rows(q, lse, delta)
    d = q.shape[3]
    width = kernel_width(d)
    if width != d:
        q, k, v, g = _pad_head_dim(width, q, k, v, g)
        flash_attention_bwd_dkv.padded_launches += 1
    dk, dv = _launch_dkv(*_route('bwd_dkv', width, q.dtype), q, k, v, g,
                         lse, delta, causal, d**-0.5)
    if width == d:
        return dk, dv
    return dk[..., :d].contiguous(), dv[..., :d].contiguous()


flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.padded_launches = 0





def plan_dkv_256_split(b: int, hq: int, hkv: int, s: int, causal: bool,
                       sms: int = H100_SMS) -> int:
    """How many ranges the dk/dv kernel at 256 cuts each kv tile's query
    work into.  A kv tile of DKV_256_BLOCK rows takes Hq / Hkv query heads
    times its q tiles (when causal, those from its diagonal down) steps,
    and the grid has B * Hkv * n_tiles CTAs.  Under MQA that grid is short
    and the causal tile 0 far heavier than an SM's share of all the steps.
    The split doubles (up to DKV_256_MAX_SPLIT, and no further than tile
    0's steps) while the least time the grid can take, in steps (the
    heaviest range, or the steps over the SMs the grid can fill), is more
    than DKV_256_SLACK times the card's share (all the steps over `sms`).
    Each doubling also writes and sums split * B * Hkv * S * D * 8 bytes
    of f32 partials more, hence the slack: on an H100 the split this
    picks at Gemma-2B's training and serving shapes (2 and 4) measured
    faster than the next one, whose heaviest range is within the share."""
    n_tiles = -(-s // DKV_256_BLOCK)
    heaviest = hq // hkv * n_tiles
    steps = b * hq * (n_tiles * (n_tiles + 1) // 2 if causal
                      else n_tiles * n_tiles)
    share = -(-steps // sms)

    def least_steps(split: int) -> int:
        grid = b * hkv * n_tiles * split
        return max(-(-heaviest // split), -(-steps // min(sms, grid)))

    split = 1
    while (split < DKV_256_MAX_SPLIT and 2 * split <= heaviest and
           least_steps(split) > DKV_256_SLACK * share):
        split *= 2
    return split


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_dkv(entry: str, wrapper, q, k, v, g, lse, delta, causal,
                scale):
    """Launch a dk/dv kernel through its C entry on checked CUDA inputs and
    count the launch on `wrapper`.  The kernel at 256 also takes its
    split (plan_dkv_256_split) and, above 1, an f32 workspace for the
    partials."""
    b, hq, s, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    split_args = ()
    if entry == 'skytpu_flash_attention_bwd_dkv_256':
        split = plan_dkv_256_split(b, hq, k.shape[1], s, causal,
                                   _sm_count(q.device))
        partial = (torch.empty((split, 2, *k.shape), dtype=torch.float32,
                               device=q.device) if split > 1 else None)
        split_args = (None if partial is None else partial.data_ptr(), split)
    lib = _LIBRARY.get()
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, hq, k.shape[1], s, d, _DTYPE_CODES[q.dtype], scale,
            int(causal), *split_args, _stream(q.device))
    _raise_on(err, wrapper.__name__)
    wrapper.launches += 1
    return dk, dv


def flash_attention_bwd(q: torch.Tensor,
                        k: torch.Tensor,
                        v: torch.Tensor,
                        out: torch.Tensor,
                        lse: torch.Tensor,
                        g: torch.Tensor,
                        causal: bool = True,
                        block_size: int = 512):
    """Flash backward.  q/out/g [B,Hq,S,D], k/v [B,Hkv,S,D], lse
    [B,Hq,S] f32.  Returns (dq, dk, dv) with dk/dv at Hkv heads."""
    if q.dim() != 4:
        raise ValueError(f'q must be [B, H, S, D], got {tuple(q.shape)}')
    _check_block(q.shape[2], block_size)
    _device_type(q, k, v, out, lse, g)
    delta = _delta(out, g)
    dq = flash_attention_bwd_dq(q, k, v, g, lse, delta, causal)
    dk, dv = flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal)
    return dq, dk, dv


# ----- the per-route wrappers -------------------------------------------------

# The per-route wrappers, one per kernel and route suffix: the dtypes each
# takes, its kind of kernel and the sources of its kernels.  Its head dims
# are the widths _ROUTE_SUFFIX gives the suffix (f32: every width).
_ROUTE_WRAPPERS = {
    '_small': (_HALF_DTYPES, 'mma.sync', '{}_small.cu'),
    '_wide': (_HALF_DTYPES, 'mma.sync', '{}_wide.cu'),
    '_256': (_HALF_DTYPES, 'wgmma', '{}_256.cu'),
    '_f32': (_F32_DTYPES, 'mma.sync', '{}_f32.cu`, `{}_f32_wide.cu'),
}


def route_head_dims(suffix: str) -> Tuple[int, ...]:
    """The kernel widths the route `suffix` takes."""
    if suffix == '_f32':
        return KERNEL_WIDTHS
    return tuple(sorted(w for w, sfx in _ROUTE_SUFFIX.items()
                        if sfx == suffix))


def _route_wrapper(kernel: str, suffix: str):
    """The wrapper of `kernel`'s ('fwd', 'bwd_dq' or 'bwd_dkv') route
    `suffix`: the public wrapper's contract at that route's head dims and
    dtypes (CPU tensors take the plain version), the launches of its C
    entry counted in `.launches`."""
    dtypes, design, files = _ROUTE_WRAPPERS[suffix]
    head_dims = route_head_dims(suffix)
    what = ('in f32 (3xTF32) ' if suffix == '_f32' else '') + (
        f'at head_dim {", ".join(map(str, head_dims[:-1]))} or '
        f'{head_dims[-1]}' if len(head_dims) > 1
        else f'at head_dim {head_dims[0]}')
    name = f'flash_attention_{kernel}{suffix}'
    entry = f'skytpu_{name}'
    if kernel == 'fwd':

        def wrapper(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, return_residuals: bool = False):
            if _device_type(q, k, v) == 'cpu':
                return flash_attention_fwd_reference(
                    q, k, v, causal=causal, return_residuals=return_residuals)
            _check_cuda_inputs(q, k, v, head_dims=head_dims, dtypes=dtypes)
            return _launch_fwd(entry, wrapper, q, k, v, causal,
                               return_residuals, q.shape[3]**-0.5)
    else:
        reference, launch = {
            'bwd_dq': (flash_attention_bwd_dq_reference, '_launch_dq'),
            'bwd_dkv': (flash_attention_bwd_dkv_reference, '_launch_dkv'),
        }[kernel]

        def wrapper(q, k, v, g, lse, delta, causal: bool = True):
            if _device_type(q, k, v, g, lse, delta) == 'cpu':
                return reference(q, k, v, g, lse, delta, causal)
            _check_cuda_inputs(q, k, v, g, head_dims=head_dims,
                               dtypes=dtypes)
            _check_rows(q, lse, delta)
            return globals()[launch](entry, wrapper, q, k, v, g, lse, delta,
                                     causal, q.shape[3]**-0.5)
    sources_ = files.format(f'csrc/flash_attention_{kernel}',
                            f'csrc/flash_attention_{kernel}')
    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = (f'The {design} {kernel} kernel {what} (`{sources_}`): '
                       f'`flash_attention_{kernel}`\'s contract, whose '
                       f'launches on this route it counts.')
    wrapper.launches = 0
    return wrapper


flash_attention_fwd_small = _route_wrapper('fwd', '_small')
flash_attention_fwd_wide = _route_wrapper('fwd', '_wide')
flash_attention_fwd_256 = _route_wrapper('fwd', '_256')
flash_attention_fwd_f32 = _route_wrapper('fwd', '_f32')
flash_attention_bwd_dq_small = _route_wrapper('bwd_dq', '_small')
flash_attention_bwd_dq_wide = _route_wrapper('bwd_dq', '_wide')
flash_attention_bwd_dq_256 = _route_wrapper('bwd_dq', '_256')
flash_attention_bwd_dq_f32 = _route_wrapper('bwd_dq', '_f32')
flash_attention_bwd_dkv_small = _route_wrapper('bwd_dkv', '_small')
flash_attention_bwd_dkv_wide = _route_wrapper('bwd_dkv', '_wide')
flash_attention_bwd_dkv_256 = _route_wrapper('bwd_dkv', '_256')
flash_attention_bwd_dkv_f32 = _route_wrapper('bwd_dkv', '_f32')
