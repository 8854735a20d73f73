"""Hand-written Hopper flash-attention forward, bound with ctypes.

PyTorch/CUDA counterpart of `skypilot_tpu/ops/pallas/flash_attention.py::
flash_attention_fwd` (the Pallas `_fa_kernel`).  Same signature, same
layouts: q [B, Hq, S, D], k/v [B, Hkv, S, D] -> out [B, Hq, S, D] in q's
dtype and, with `return_residuals=True`, the row logsumexp [B, Hq, S] f32
(+inf for all-masked rows).  GQA reads kv head h // (Hq // Hkv) inside
the kernel.

The kernel (`skypilot_tpu_torch/csrc/flash_attention_fwd.cu`) is compiled
with nvcc for sm_90a into a shared library with a plain C interface at
first use, under `build/skypilot_tpu_torch/` beside the package, and
launched on PyTorch's current stream.  `block_size` keeps the TPU
wrapper's contract (S must divide min(block_size, S)); the CUDA kernel
tiles at 64 rows and masks the ragged edge itself.

CPU tensors take `flash_attention_fwd_reference`, the plain PyTorch
version of the same function; a CUDA tensor always launches the kernel
or raises.  `flash_attention_fwd.launches` counts kernel launches.
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
from typing import Optional

import torch

_NEG_INF = -1e30
_PKG_DIR = pathlib.Path(__file__).resolve().parents[2]
SOURCE = _PKG_DIR / 'csrc' / 'flash_attention_fwd.cu'
BUILD_DIR = _PKG_DIR.parent / 'build' / 'skypilot_tpu_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
_DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1}
_HEAD_DIMS = (64, 128)


class _Library:
    """The compiled kernel library: built once per process (content-
    addressed on disk, so a rebuilt source never loads a stale binary)."""

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
                f'attention kernel is compiled on the machine with the GPU')
        return nvcc

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = self._build_and_load()
            return self._lib

    def _build_and_load(self) -> ctypes.CDLL:
        src = SOURCE.read_bytes()
        digest = hashlib.sha256(src + ' '.join(NVCC_FLAGS).encode())
        out = BUILD_DIR / f'libflash_attention_fwd-{digest.hexdigest()[:16]}.so'
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # Compile to a private name, then rename: a concurrent build in
            # another process never loads a half-written library.
            fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [self._nvcc(), *NVCC_FLAGS, '-o', tmp, str(SOURCE)],
                    capture_output=True, text=True, check=False)
                self.build_log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(
                        f'nvcc failed ({proc.returncode}):\n{self.build_log}')
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(out))
        fn = lib.skytpu_flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 +
                       [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        return lib


_LIBRARY = _Library()


def build() -> str:
    """Compile (if needed) and load the kernel library; returns nvcc's
    output of this process's build (ptxas registers, shared memory and
    spills), empty when an earlier build was reused."""
    _LIBRARY.get()
    return _LIBRARY.build_log


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


def _check_cuda_inputs(q, k, v) -> None:
    b, hq, s, d = q.shape
    for name, t in (('q', q), ('k', k), ('v', v)):
        if t.device != q.device:
            raise ValueError(f'{name} is on {t.device}, q on {q.device}')
        if t.dtype != q.dtype:
            raise ValueError(f'{name} is {t.dtype}, q is {q.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
        if t.data_ptr() % 16:
            raise ValueError(f'{name} must be 16-byte aligned')
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f'flash_attention_fwd kernel takes bf16/fp16, '
                         f'got {q.dtype}')
    if d not in _HEAD_DIMS:
        raise ValueError(f'head_dim {d} not in {_HEAD_DIMS}')
    if (k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or
            k.shape[2] != s or k.shape[3] != d or hq % k.shape[1]):
        raise ValueError(f'bad shapes q {tuple(q.shape)} k {tuple(k.shape)} '
                         f'v {tuple(v.shape)}')


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
    s = q.shape[2]
    block = min(block_size, s)
    if s % block:
        raise ValueError(f'seq len {s} must divide block size {block}')
    devices = {q.device.type, k.device.type, v.device.type}
    if devices == {'cpu'}:
        return flash_attention_fwd_reference(
            q, k, v, causal=causal, return_residuals=return_residuals)
    if devices != {'cuda'}:
        raise ValueError(f'flash_attention_fwd takes CPU or CUDA tensors, '
                         f'got {sorted(devices)}')
    _check_cuda_inputs(q, k, v)
    b, hq, _, d = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
           if return_residuals else None)
    lib = _LIBRARY.get()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.skytpu_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            b, hq, k.shape[1], s, d, _DTYPE_CODES[q.dtype], d**-0.5,
            int(causal), stream)
    if err != 0:
        raise RuntimeError(f'flash_attention_fwd kernel launch failed: '
                           f'cudaError {err}')
    flash_attention_fwd.launches += 1
    return (out, lse) if return_residuals else out


flash_attention_fwd.launches = 0
