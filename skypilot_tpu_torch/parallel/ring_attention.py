"""Ring attention: exact context parallelism over a mesh axis (PyTorch).

Twin of `skypilot_tpu/parallel/ring_attention.py`.  The sequence is
sharded over the mesh's ``fsdp`` axis: each rank holds its chunk of Q,
K and V ([B, H, S_local, D], chunk i = positions i*S_local ..), and
every hop attends its Q against the K/V chunk it currently holds, then
passes that chunk one rank on (rank+1) around the axis group.

`ring_attention` is one `torch.autograd.Function` over the hand-written
Hopper kernels of `ops/cuda/flash_attention.py` (their plain versions on
CPU tensors):
- forward, per hop: the flash forward with its row logsumexp on this
  rank's Q against the held chunk, causal on the diagonal hop (the
  rank's own chunk), full for an earlier chunk, skipped for a later one
  under causal attention; each hop's (out, lse) merged into f32
  accumulators by the online-softmax merge of the JAX `_combine`.  The
  next chunk's P2P transfer is issued before the hop's kernel, so the
  copy overlaps it.
- backward: delta = rowsum(dO * O) once from the final output; per hop
  the dq and the dk/dv kernels with the FINAL lse and delta and the
  forward hop's causal flag and skip rule.  dK/dV accumulate in f32 and
  travel with their K/V chunk, which is back on its home rank after the
  last hop.

No row is ever empty: hop 0 is always the diagonal, where every row sees
its own position, so the accumulators start from a finite lse.

Transport: P2P `batch_isend_irecv` on the axis group.  A gloo group over
CUDA tensors stages each transfer through pinned host buffers, decided
from the group's backend before the first hop.

`ring_attention_reference` keeps the JAX module's einsum loop
(`_block_attend` / `_combine` over the whole sequence, no kernel): the
plain version the card's ring is held against.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from skypilot_tpu_torch.ops.attention import _expand_kv
from skypilot_tpu_torch.ops.cuda import flash_attention as cuda_fa

_NEG_INF = -1e30


class _Ring:
    """This rank's place on the ring of `group`: its index, the global
    ranks it sends to (`shift` places on) and receives from (`shift`
    places back), and whether transfers of CUDA tensors hop through host
    memory (a gloo group).  The pipeline's hop (`parallel/pipeline.py`)
    rides the same ring, backward with `shift=-1`."""

    def __init__(self, group, device: torch.device, shift: int = 1) -> None:
        ranks = dist.get_process_group_ranks(group)
        self.group = group
        self.n = len(ranks)
        self.idx = dist.get_group_rank(group, dist.get_rank())
        self.next = ranks[(self.idx + shift) % self.n]
        self.prev = ranks[(self.idx - shift) % self.n]
        self.via_host = (device.type == 'cuda' and
                         dist.get_backend(group) == 'gloo')

    def chunk_of(self, hop: int) -> int:
        """The chunk this rank holds at `hop` (its own at hop 0)."""
        return (self.idx - hop) % self.n

    def start(self, tensors: Sequence[torch.Tensor]):
        """Send `tensors` to the next rank and receive as many from the
        previous one; returns a handle for `finish`.  A ring of one keeps
        its tensors."""
        if self.n == 1:
            return [], list(tensors), list(tensors), None
        if self.via_host:
            # Pinned host buffers; the device-to-host copy waits for the
            # kernels that produced the tensors (it syncs the host).
            sends = [torch.empty(t.shape, dtype=t.dtype, device='cpu',
                                 pin_memory=True).copy_(t) for t in tensors]
            recvs = [torch.empty(t.shape, dtype=t.dtype, device='cpu',
                                 pin_memory=True) for t in tensors]
        else:
            sends, recvs = list(tensors), [torch.empty_like(t)
                                           for t in tensors]
        ops = [dist.P2POp(dist.isend, t, self.next, self.group)
               for t in sends]
        ops += [dist.P2POp(dist.irecv, t, self.prev, self.group)
                for t in recvs]
        device = tensors[0].device if self.via_host else None
        return dist.batch_isend_irecv(ops), sends, recvs, device

    def finish(self, handle) -> List[torch.Tensor]:
        works, _, recvs, device = handle
        for work in works:
            work.wait()
        if device is not None:
            return [t.to(device, non_blocking=True) for t in recvs]
        return recvs


def _hop_flag(ring: _Ring, hop: int, causal: bool) -> Optional[bool]:
    """The hop's causal flag, or None when causal attention skips it (a
    chunk later than this rank's)."""
    kv = ring.chunk_of(hop)
    if causal and kv > ring.idx:
        return None
    return causal and kv == ring.idx


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           block_size: int) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.shape[2] != q.shape[2]:
        raise ValueError(f'ring attention takes q [B, Hq, S_local, D] and '
                         f'k/v [B, Hkv, S_local, D] chunks, got '
                         f'{tuple(q.shape)} {tuple(k.shape)} '
                         f'{tuple(v.shape)}')
    s = q.shape[2]
    if s % min(block_size, s):
        raise ValueError(f'the chunk length {s} must divide the kernels\' '
                         f'block {block_size}')
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError('ring attention takes contiguous q, k and v')


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, group, causal, block_size):
        _check(q, k, v, block_size)
        ring = _Ring(group, q.device)
        out_acc = lse_acc = None
        kv = (k, v)
        for hop in range(ring.n):
            handle = ring.start(kv) if hop < ring.n - 1 else None
            flag = _hop_flag(ring, hop, causal)
            if flag is not None:
                out, lse = cuda_fa.flash_attention_fwd(
                    q, kv[0], kv[1], causal=flag, block_size=block_size,
                    return_residuals=True)
                if out_acc is None:
                    # Hop 0, the diagonal: every row attends at least its
                    # own position, so this lse is finite everywhere.
                    out_acc, lse_acc = out.float(), lse
                else:
                    lse_new = torch.logaddexp(lse_acc, lse)
                    out_acc = (out_acc * torch.exp(lse_acc - lse_new)[..., None]
                               + out.float() *
                               torch.exp(lse - lse_new)[..., None])
                    lse_acc = lse_new
            if handle is not None:
                kv = tuple(ring.finish(handle))
        out = out_acc.to(q.dtype)
        ctx.group, ctx.causal, ctx.block_size = group, causal, block_size
        ctx.save_for_backward(q, k, v, out, lse_acc.contiguous())
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        # The gradient usually arrives as a transposed view (the model
        # reshapes [B, H, S, D] to [B, S, H*D]); the kernels take
        # contiguous tensors.
        g = g.contiguous()
        ring = _Ring(ctx.group, q.device)
        delta = cuda_fa._delta(out, g)  # pylint: disable=protected-access
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kv = (k, v)
        dkv = [torch.zeros(k.shape, dtype=torch.float32, device=k.device),
               torch.zeros(v.shape, dtype=torch.float32, device=v.device)]
        for hop in range(ring.n):
            # K/V for the next hop travel while this hop's kernels run;
            # dK/dV follow their chunk once this hop has added to them.
            handle = ring.start(kv) if hop < ring.n - 1 else None
            flag = _hop_flag(ring, hop, ctx.causal)
            if flag is not None:
                dq += cuda_fa.flash_attention_bwd_dq(
                    q, kv[0], kv[1], g, lse, delta, causal=flag).float()
                dk, dv = cuda_fa.flash_attention_bwd_dkv(
                    q, kv[0], kv[1], g, lse, delta, causal=flag)
                dkv[0] += dk.float()
                dkv[1] += dv.float()
            if handle is not None:
                kv = tuple(ring.finish(handle))
            dkv = ring.finish(ring.start(dkv))
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None)


def ring_attention(q: torch.Tensor,
                   k: torch.Tensor,
                   v: torch.Tensor,
                   mesh,
                   axis_name: str = 'fsdp',
                   causal: bool = True,
                   block_size: int = 512) -> torch.Tensor:
    """Exact attention over a sequence sharded on `axis_name` of `mesh`
    (a `parallel.mesh.RankMesh`): q [B, Hq, S_local, D], k/v
    [B, Hkv, S_local, D] are this rank's chunk (the chunk index is its
    coordinate on the axis), the output is this rank's chunk of the
    attention output.  Other axes pass through (batch rows on 'data',
    heads on 'tensor').  Differentiable in q, k and v."""
    return _RingAttention.apply(q, k, v, mesh.group(axis_name), causal,
                                block_size)


# ----- the plain version (the JAX module's einsum loop) ------------------------


def _block_attend(q, k, v, q_pos, k_pos, causal):
    """Partial attention of q against one K/V block: (numerator
    [B,H,Sq,D] f32, rowmax [B,H,Sq] f32, denominator [B,H,Sq] f32), as
    the JAX `_block_attend`."""
    scale = q.shape[-1]**-0.5
    k = _expand_kv(k, q.shape[1])
    v = _expand_kv(v, q.shape[1])
    s = torch.einsum('bhqd,bhkd->bhqk', q.float(), k.float()) * scale
    if causal:
        mask = q_pos[:, None, :, None] >= k_pos[:, None, None, :]
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(m[..., None] <= _NEG_INF / 2, torch.zeros_like(p), p)
    l = p.sum(dim=-1)
    num = torch.einsum('bhqk,bhkd->bhqd', p.to(v.dtype).float(), v.float())
    return num, m, l


def _combine(acc, num, m_acc, m_blk, l_acc, l_blk):
    """Merge one block's online-softmax triple into the accumulator."""
    m_new = torch.maximum(m_acc, m_blk)
    c_acc = torch.exp(m_acc - m_new)
    c_blk = torch.exp(m_blk - m_new)
    acc = acc * c_acc[..., None] + num * c_blk[..., None]
    l_new = l_acc * c_acc + l_blk * c_blk
    return acc, m_new, l_new


def ring_attention_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, n_chunks: int,
                             causal: bool = True) -> torch.Tensor:
    """The whole sequence's ring attention in one process: q
    [B, Hq, S, D], k/v [B, Hkv, S, D] cut into `n_chunks` chunks, each
    chunk's Q against every K/V chunk in the ring's order by
    `_block_attend` and `_combine` (the JAX module's loop, plain
    PyTorch); returns [B, Hq, S, D] in q's dtype."""
    s = q.shape[2]
    if s % n_chunks:
        raise ValueError(f'{n_chunks} chunks do not divide S={s}')
    s_local = s // n_chunks
    outs = []
    for idx in range(n_chunks):
        q_c = q[:, :, idx * s_local:(idx + 1) * s_local]
        q_pos = (idx * s_local + torch.arange(s_local,
                                              device=q.device))[None, :]
        acc = torch.zeros(q_c.shape, dtype=torch.float32, device=q.device)
        m_acc = torch.full(q_c.shape[:3], _NEG_INF, dtype=torch.float32,
                           device=q.device)
        l_acc = torch.zeros(q_c.shape[:3], dtype=torch.float32,
                            device=q.device)
        for hop in range(n_chunks):
            kv_idx = (idx - hop) % n_chunks
            sl = slice(kv_idx * s_local, (kv_idx + 1) * s_local)
            k_pos = (kv_idx * s_local + torch.arange(
                s_local, device=q.device))[None, :]
            num, m_blk, l_blk = _block_attend(q_c, k[:, :, sl], v[:, :, sl],
                                              q_pos, k_pos, causal)
            acc, m_acc, l_acc = _combine(acc, num, m_acc, m_blk, l_acc,
                                         l_blk)
        safe_l = torch.where(l_acc == 0.0, torch.ones_like(l_acc), l_acc)
        outs.append((acc / safe_l[..., None]).to(q.dtype))
    return torch.cat(outs, dim=2)


def chunk_positions(mesh, s_local: int, device: torch.device,
                    axis_name: str = 'fsdp') -> torch.Tensor:
    """The absolute positions [S_local] of this rank's chunk."""
    start = mesh.coordinate(axis_name) * s_local
    return torch.arange(start, start + s_local, device=device)
