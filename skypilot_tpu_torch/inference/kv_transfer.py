"""KV-page handoff between prefill and decode replicas (disaggregated
serving), PyTorch side.

Twin of `skypilot_tpu/inference/kv_transfer.py`, byte for byte on the
wire, so a payload crosses between the two packages in either
direction.  A prefill replica exports a request's pages plus the
sampled first token as ONE binary payload; the decode replica adopts
the pages into its own pool at page granularity and continues decoding.

Wire format (version 1, little-endian):

    MAGIC 'SKVT1' | u32 header_len | header JSON (utf-8) | page data

The header carries dtype/shape per cache leaf, the page geometry, the
prompt ids, the sampled first token and a CRC32 of the page data, so a
truncated or corrupted transfer fails loudly at parse time.  Page data
is LAYER-MAJOR: all of leaf 0's pages (``[n_pages, heads, page_size,
head_dim]``, C-contiguous), then leaf 1's, in the JAX cache tree's leaf
order (the engine's `_leaf_order`).

A tensor-parallel engine's payload is the same: its export gathers
every rank's kv heads, and its adopt keeps each rank's heads of a
payload (inference/engine.py), so a payload crosses between tensor
degrees as it crosses between the packages.

Leaves here are CPU tensors.  bf16 has no numpy dtype without the
`ml_dtypes` package, so a bf16 leaf is written as its raw 2-byte bits
under the dtype name 'bfloat16' (the name the JAX side writes) and read
back through `np.uint16` into `torch.bfloat16`.

Push: the serve LB stamps ``X-Skytpu-Decode-Url`` (candidate decode
replicas, comma-separated, in preference order) on the request it
proxies to the prefill pool; the prefill replica POSTs the payload to
``/v1/kv_adopt`` on the first candidate that accepts, with a hard
client timeout; a failed candidate passes the same payload to the next.
"""
from __future__ import annotations

import dataclasses
import json
import time
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from skypilot_tpu_torch import sky_logging
from skypilot_tpu_torch.server import metrics as metrics_lib

logger = sky_logging.init_logger(__name__)

_MAGIC = b'SKVT1'
VERSION = 1

# Stamped by the serve LB on requests proxied to the PREFILL pool: the
# decode replicas (comma-separated URLs, in routing-policy preference
# order) the prefill replica should push this request's KV pages to.
DECODE_URL_HEADER = 'X-Skytpu-Decode-Url'
# Route the decode replica accepts handoff payloads on.
ADOPT_ROUTE = '/v1/kv_adopt'

# Hard deadline for one handoff push (connect + upload + the decode
# replica's FULL generation, since the adopt response carries the
# completion): a wedged decode replica must fail the push so the next
# candidate (or the local monolithic fallback) gets the request.
DEFAULT_PUSH_TIMEOUT_SECONDS = 300.0
# The transfer itself (connect + request write) gets a much tighter
# bound: a transfer that cannot start quickly fails over.
DEFAULT_CONNECT_TIMEOUT_SECONDS = 10.0

# Wire dtype name <-> torch dtype of the leaves a pool can hold.
_TORCH_DTYPES = {'bfloat16': torch.bfloat16, 'float16': torch.float16,
                 'float32': torch.float32, 'int8': torch.int8}
_WIRE_NAMES = {dtype: name for name, dtype in _TORCH_DTYPES.items()}


@dataclasses.dataclass
class KVHandoff:
    """One request's transferable prefill state."""
    prompt_ids: List[int]
    first_token: int
    max_new_tokens: int
    page_size: int
    # Per cache leaf: [n_kv_pages, heads, page_size, head_dim] CPU
    # tensor (scales [n_kv_pages, heads, page_size]), wire leaf order.
    leaves: List[torch.Tensor]
    request_id: Optional[str] = None

    @property
    def n_kv_pages(self) -> int:
        return self.leaves[0].shape[0] if self.leaves else 0


def _leaf_bytes(leaf: torch.Tensor) -> Tuple[bytes, str]:
    """(raw C-order bytes, wire dtype name) of one CPU leaf."""
    leaf = leaf.detach().cpu().contiguous()
    name = _WIRE_NAMES.get(leaf.dtype)
    if name is None:
        raise ValueError(f'kv-handoff leaf dtype {leaf.dtype} has no wire '
                         f'name')
    if leaf.dtype == torch.bfloat16:
        leaf = leaf.view(torch.int16)
    return leaf.numpy().tobytes(), name


def serialize(handoff: KVHandoff) -> bytes:
    """KVHandoff -> one self-describing binary payload."""
    blobs = []
    leaf_meta = []
    for leaf in handoff.leaves:
        blob, name = _leaf_bytes(leaf)
        blobs.append(blob)
        leaf_meta.append({'shape': list(leaf.shape), 'dtype': name})
    data = b''.join(blobs)
    header = {
        'version': VERSION,
        'prompt_ids': list(map(int, handoff.prompt_ids)),
        'first_token': int(handoff.first_token),
        'max_new_tokens': int(handoff.max_new_tokens),
        'page_size': int(handoff.page_size),
        'request_id': handoff.request_id,
        'leaves': leaf_meta,
        'data_bytes': len(data),
        'crc32': zlib.crc32(data) & 0xffffffff,
    }
    hdr = json.dumps(header, separators=(',', ':')).encode('utf-8')
    return b''.join([_MAGIC, len(hdr).to_bytes(4, 'little'), hdr, data])


def _leaf_from(data: bytes, name: str, shape: tuple, offset: int):
    """(CPU tensor, byte count) of one leaf of the data section."""
    if name not in _TORCH_DTYPES:
        raise ValueError(f'kv-handoff payload: unknown leaf dtype {name!r}')
    dtype = _TORCH_DTYPES[name]
    np_dtype = (np.uint16 if dtype == torch.bfloat16
                else np.dtype(name))
    count = int(np.prod(shape))
    nbytes = count * np.dtype(np_dtype).itemsize
    if offset + nbytes > len(data):
        raise ValueError('kv-handoff payload: leaf sizes do not cover '
                         'the data section')
    arr = np.frombuffer(data, dtype=np_dtype, count=count,
                        offset=offset).reshape(shape)
    # A private, writable copy (frombuffer views the payload read-only).
    leaf = torch.from_numpy(arr.copy())
    if dtype == torch.bfloat16:
        leaf = leaf.view(torch.bfloat16)
    return leaf, nbytes


def deserialize(payload: bytes) -> KVHandoff:
    """Parse + integrity-check one payload; raises ValueError on any
    corruption (magic, truncation, checksum, shape mismatch): a bad
    transfer must never scatter garbage into a live KV pool."""
    if len(payload) < len(_MAGIC) + 4 or \
            payload[:len(_MAGIC)] != _MAGIC:
        raise ValueError('kv-handoff payload: bad magic')
    off = len(_MAGIC)
    hdr_len = int.from_bytes(payload[off:off + 4], 'little')
    off += 4
    if len(payload) < off + hdr_len:
        raise ValueError('kv-handoff payload: truncated header')
    try:
        header = json.loads(payload[off:off + hdr_len].decode('utf-8'))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f'kv-handoff payload: unparseable header: {e}')
    if header.get('version') != VERSION:
        raise ValueError(f'kv-handoff payload: version '
                         f'{header.get("version")} != {VERSION}')
    off += hdr_len
    data = payload[off:]
    if len(data) != header['data_bytes']:
        raise ValueError(
            f'kv-handoff payload: data truncated '
            f'({len(data)} of {header["data_bytes"]} bytes)')
    if (zlib.crc32(data) & 0xffffffff) != header['crc32']:
        raise ValueError('kv-handoff payload: checksum mismatch')
    leaves = []
    pos = 0
    for meta in header['leaves']:
        leaf, nbytes = _leaf_from(data, meta['dtype'], tuple(meta['shape']),
                                  pos)
        leaves.append(leaf)
        pos += nbytes
    if pos != len(data):
        raise ValueError('kv-handoff payload: leaf sizes do not cover '
                         'the data section')
    return KVHandoff(prompt_ids=header['prompt_ids'],
                     first_token=header['first_token'],
                     max_new_tokens=header['max_new_tokens'],
                     page_size=header['page_size'],
                     leaves=leaves,
                     request_id=header.get('request_id'))


def parse_decode_targets(header_value: Optional[str]) -> List[str]:
    """The LB's decode-candidate header -> ordered URL list."""
    if not header_value:
        return []
    return [u.strip() for u in header_value.split(',') if u.strip()]


async def push(session, decode_urls: Sequence[str], payload: bytes,
               request_id: Optional[str] = None,
               timeout_s: float = DEFAULT_PUSH_TIMEOUT_SECONDS,
               ) -> Tuple[Optional[Dict], Optional[str]]:
    """Push one payload to the first decode replica that takes it.

    Tries ``decode_urls`` in order; a candidate that fails (connect
    refused, timeout, non-200) is skipped and the SAME payload goes to
    the next one: re-routing costs one RPC, never a re-prefill.  Returns
    (decode replica's JSON completion, winning URL), or (None, None)
    when every candidate failed (the caller falls back to monolithic
    serving).
    """
    import aiohttp

    from skypilot_tpu_torch.server import tracing
    headers = {'Content-Type': 'application/octet-stream'}
    if request_id:
        headers[tracing.TRACE_HEADER] = request_id
    for url in decode_urls:
        t0 = time.perf_counter()
        outcome = 'error'
        try:
            async with session.post(
                    url.rstrip('/') + ADOPT_ROUTE, data=payload,
                    headers=headers,
                    timeout=aiohttp.ClientTimeout(
                        total=timeout_s,
                        sock_connect=DEFAULT_CONNECT_TIMEOUT_SECONDS,
                    )) as resp:
                if resp.status == 200:
                    body = await resp.json()
                    outcome = 'ok'
                    metrics_lib.inc_counter(
                        'skytpu_lb_kv_transfer_bytes_total',
                        float(len(payload)))
                    return body, url
                logger.warning(
                    f'kv handoff to {url} rejected: {resp.status}')
        except Exception as e:  # pylint: disable=broad-except
            # aiohttp client errors, timeouts, DNS: all mean "this
            # candidate is out"; the next one gets the payload.
            logger.warning(f'kv handoff to {url} failed: {e}')
        finally:
            metrics_lib.inc_counter('skytpu_lb_kv_transfer_total',
                                    outcome=outcome)
            metrics_lib.observe_hist(
                'skytpu_lb_kv_transfer_seconds',
                time.perf_counter() - t0, outcome=outcome)
    return None, None
