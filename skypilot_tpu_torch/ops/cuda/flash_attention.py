"""Hand-written Hopper flash-attention kernels, bound with ctypes.

PyTorch/CUDA counterparts of `skypilot_tpu/ops/pallas/flash_attention.py`:

- `flash_attention_fwd` (the Pallas `_fa_kernel`): q [B, Hq, S, D], k/v
  [B, Hkv, S, D] -> out [B, Hq, S, D] in q's dtype and, with
  `return_residuals=True`, the row logsumexp [B, Hq, S] f32 (+inf for
  all-masked rows).  Source `csrc/flash_attention_fwd.cu` (wgmma, a TMA
  ring of K/V stages, the softmax in registers) at head_dim 64 and 128;
  at head_dim 16 and 32 it hands the call to `flash_attention_fwd_small`
  (`csrc/flash_attention_fwd_small.cu`: mma.sync m16n8k16, K/V tiles by
  cp.async), whose launches it counts apart.
- `flash_attention_bwd` (the Pallas `flash_attention_bwd`): the same
  contract minus `interpret`; delta = rowsum(dO * O) in PyTorch, then
  `flash_attention_bwd_dq` (`_fa_bwd_dq_kernel`; source
  `csrc/flash_attention_bwd_dq.cu`, wgmma, a TMA ring of K/V stages, dS
  in registers) and `flash_attention_bwd_dkv` (`_fa_bwd_dkv_kernel`,
  dk/dv already summed to Hkv heads; source
  `csrc/flash_attention_bwd_dkv.cu`, wgmma with P^T and dS^T in
  registers).  The Hopper building blocks the three kernels share are in
  `csrc/sm90_common.cuh`.

GQA reads kv head h // (Hq // Hkv) inside the kernels.  Every source in
`csrc/` is compiled with nvcc for sm_90a (one process per source, in
parallel) and linked into one shared library with a plain C interface,
named by a hash of all sources, headers and flags, at first use, under
`build/skypilot_tpu_torch/` beside the package; kernels launch on
PyTorch's current stream.  `block_size` keeps the TPU wrappers' contract
(S must divide min(block_size, S)); the CUDA kernels pick their own tiles
and mask the ragged edge themselves.

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
_DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1}
# Head dims of the wgmma kernels (forward, dq, dk/dv), and the small ones
# only the mma.sync forward takes.
_HEAD_DIMS = (64, 128)
_SMALL_HEAD_DIMS = (16, 32)
_FWD_HEAD_DIMS = _SMALL_HEAD_DIMS + _HEAD_DIMS
_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes.
_SIGNATURES = {
    'skytpu_flash_attention_fwd':
        [_P] * 5 + [_I] * 6 + [ctypes.c_float, _I, _P],
    'skytpu_flash_attention_fwd_small':
        [_P] * 5 + [_I] * 6 + [ctypes.c_float, _I, _P],
    'skytpu_flash_attention_bwd_dq':
        [_P] * 7 + [_I] * 6 + [ctypes.c_float, _I, _P],
    'skytpu_flash_attention_bwd_dkv':
        [_P] * 8 + [_I] * 6 + [ctypes.c_float, _I, _P],
}


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


def _check_cuda_inputs(q, k, v, *same_as_q, head_dims=_HEAD_DIMS) -> None:
    """q and same_as_q [B,Hq,S,D], k/v [B,Hkv,S,D]: one device and dtype
    (bf16/fp16), head_dim in `head_dims`, contiguous and 16-byte
    aligned."""
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
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f'flash-attention kernels take bf16/fp16, '
                         f'got {q.dtype}')
    if d not in head_dims:
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


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f'{name} kernel launch failed: cudaError {err}')


# ----- forward ----------------------------------------------------------------


def flash_attention_fwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, causal: bool = True,
                                  return_residuals: bool = False):
    """Plain PyTorch version of the kernel's function, in f32: -1e30
    masking, 0 output and +inf lse for rows whose denominator is 0, then
    out cast to q's dtype."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    logits = torch.einsum('bhqd,bhkd->bhqk', q.float(), kf) * d**-0.5
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
    logsumexp [B,Hq,S] f32 with `return_residuals=True`)."""
    if q.dim() != 4:
        raise ValueError(f'q must be [B, H, S, D], got {tuple(q.shape)}')
    _check_block(q.shape[2], block_size)
    if _device_type(q, k, v) == 'cpu':
        return flash_attention_fwd_reference(
            q, k, v, causal=causal, return_residuals=return_residuals)
    _check_cuda_inputs(q, k, v, head_dims=_FWD_HEAD_DIMS)
    if q.shape[3] in _SMALL_HEAD_DIMS:
        return flash_attention_fwd_small(q, k, v, causal=causal,
                                         return_residuals=return_residuals)
    return _launch_fwd('skytpu_flash_attention_fwd', flash_attention_fwd,
                       q, k, v, causal, return_residuals)


flash_attention_fwd.launches = 0


def _launch_fwd(entry: str, wrapper, q, k, v, causal, return_residuals):
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
            b, hq, k.shape[1], s, d, _DTYPE_CODES[q.dtype], d**-0.5,
            int(causal), _stream(q.device))
    _raise_on(err, wrapper.__name__)
    wrapper.launches += 1
    return (out, lse) if return_residuals else out


def flash_attention_fwd_small(q: torch.Tensor,
                              k: torch.Tensor,
                              v: torch.Tensor,
                              causal: bool = True,
                              return_residuals: bool = False):
    """The forward at head_dim 16 or 32
    (`csrc/flash_attention_fwd_small.cu`): `flash_attention_fwd`'s
    contract, which calls it at those head dims."""
    if _device_type(q, k, v) == 'cpu':
        return flash_attention_fwd_reference(
            q, k, v, causal=causal, return_residuals=return_residuals)
    _check_cuda_inputs(q, k, v, head_dims=_SMALL_HEAD_DIMS)
    return _launch_fwd('skytpu_flash_attention_fwd_small',
                       flash_attention_fwd_small, q, k, v, causal,
                       return_residuals)


flash_attention_fwd_small.launches = 0

# ----- backward ---------------------------------------------------------------


def _recompute_p_ds(q, k, v, g, lse, delta, causal):
    """The backward's recompute in f32 (the Pallas `_recompute_p_ds`):
    P = exp(mask(Q K^T scale) - lse) with -1e30 masking, dS = P (dO V^T -
    delta) scale, at Hq heads; also returns K repeated to Hq heads."""
    hq, s, d = q.shape[1], q.shape[2], q.shape[3]
    group = hq // k.shape[1]
    scale = d**-0.5
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
                                     causal: bool = True) -> torch.Tensor:
    """Plain version of the dq kernel, in f32: dS rounded to k's dtype
    before dS K (as the TPU kernel's `ds.astype(k.dtype)`)."""
    _, ds, kf = _recompute_p_ds(q, k, v, g, lse, delta, causal)
    dq = torch.einsum('bhqk,bhkd->bhqd', ds.to(k.dtype).float(), kf)
    return dq.to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, g, lse, delta,
                                      causal: bool = True
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dk/dv kernel, in f32: P rounded to dO's dtype
    before P^T dO and dS to q's before dS^T Q (as the TPU kernel does),
    then summed over each kv head's group of query heads."""
    p, ds, _ = _recompute_p_ds(q, k, v, g, lse, delta, causal)
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
    lse, delta [B,Hq,S] f32."""
    if _device_type(q, k, v, g, lse, delta) == 'cpu':
        return flash_attention_bwd_dq_reference(q, k, v, g, lse, delta,
                                                causal)
    _check_cuda_inputs(q, k, v, g)
    _check_rows(q, lse, delta)
    b, hq, s, d = q.shape
    dq = torch.empty_like(q)
    lib = _LIBRARY.get()
    with torch.cuda.device(q.device):
        err = lib.skytpu_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, hq, k.shape[1], s, d, _DTYPE_CODES[q.dtype], d**-0.5,
            int(causal), _stream(q.device))
    _raise_on(err, 'flash_attention_bwd_dq')
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B,Hkv,S,D], each summed over its kv head's query heads;
    inputs as `flash_attention_bwd_dq`."""
    if _device_type(q, k, v, g, lse, delta) == 'cpu':
        return flash_attention_bwd_dkv_reference(q, k, v, g, lse, delta,
                                                 causal)
    _check_cuda_inputs(q, k, v, g)
    _check_rows(q, lse, delta)
    b, hq, s, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _LIBRARY.get()
    with torch.cuda.device(q.device):
        err = lib.skytpu_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, hq, k.shape[1], s, d, _DTYPE_CODES[q.dtype], d**-0.5,
            int(causal), _stream(q.device))
    _raise_on(err, 'flash_attention_bwd_dkv')
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


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
