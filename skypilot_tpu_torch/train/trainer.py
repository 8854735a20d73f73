"""Training loop for decoder LMs (PyTorch), on one device or a mesh.

Twin of `skypilot_tpu/train/trainer.py`: the same `TrainConfig`, the
same loss (`lm_loss`, f32 next-token cross-entropy), an optimizer equal
to its optax chain (global-norm clip, then AdamW on a warmup-cosine
schedule), and a `Trainer` with the same phase stamping, windowed
throughput, MFU/HBM gauges and productive-time denominators.
Parameters and optimizer state are f32; the model computes in its
`cfg.dtype` (bf16 by default), attention through the flash kernels.

Over a mesh (`parallel/mesh.py`, one process per rank), `make_train_state
(..., mesh=)` shards a Llama built on the mesh (its tensor slices, whole
over the other axes) with FSDP2: each block, then the root,
`fully_shard`ed over the mesh's 'fsdp' axis with ('dcn', 'pipeline',
'data', 'expert') as the replicate dimension (HSDP), so each rank holds
1/fsdp of every parameter and of its AdamW moments (ZeRO-3, as the JAX
rule 'embed' -> fsdp).  No rule names 'pipeline' (the
JAX trainer replicates params and batch over it), so it is one more
replicate dimension.  A MoE model's expert weights are this rank's E / expert
experts (and tensor slices), replicated over ('dcn', 'pipeline', 'data',
'fsdp'): FSDP2 leaves them alone (averaging over a replicate dimension
that holds 'expert' would mix different experts), and the step sums
their gradients over the ranks that hold the same experts
(`RankMesh.expert_mesh`).  `make_sharded_train_step` takes the GLOBAL
batch on every rank and gives JAX's global step whatever the plan:
- each rank's rows (`sharding.batch_slice`, over ('dcn', 'data',
  'fsdp', 'expert'): the rows repeat over 'pipeline'), or under ring
  attention its rows over (dcn, data) and its chunk of the sequence over
  fsdp (`sharding.context_slice`; the target of a chunk's last position
  is the next chunk's first token, and the last chunk drops its final
  position);
- the rank's mean loss weighted by its share of the B x (S-1) targets
  over the times its rows repeat, so that FSDP's gradient average over
  (replicate, shard) -- the one reduction over data and fsdp -- is the
  gradient of the global mean; an expert weight's gradient, which the
  all_to_all's backward already sums over the expert group, is summed
  over the ranks holding the same experts and divided by the same count
  FSDP divides by (that count includes 'expert': a plain average over
  the other ranks would leave it `expert` times too large);
- the clip's global norm over the whole gradient tree (optax's
  `global_norm`): squares of each rank's FSDP shard summed over the
  shard group, of its experts over the expert group, tensor-parallel
  slices also over the tensor group, a parameter replicated over tensor
  (or an expert slice over its replicas) counted once;
- AdamW elementwise on the shards (the expert weights, plain tensors,
  in a param group of their own beside FSDP2's DTensors).

No step reads a value back to the host: `loss`, `grad_norm` and `step`
stay device tensors, fetched only at log boundaries and at the end of a
run, as the JAX trainer's `jax.device_get`.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from skypilot_tpu_torch.device import DeviceLike, device_of, resolve_device
from skypilot_tpu_torch.obs import goodput as goodput_lib
from skypilot_tpu_torch.parallel import sharding
from skypilot_tpu_torch.server import metrics as metrics_lib
from skypilot_tpu_torch.train import checkpoint as ckpt_lib
from skypilot_tpu_torch.train import flops as flops_lib


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95


def learning_rate(cfg: TrainConfig, count: int) -> float:
    """optax.warmup_cosine_decay_schedule(init_value=0, peak_value=lr,
    warmup_steps, decay_steps=total_steps, end_value=0.1 lr) at update
    `count` (0 for the first update): linear from 0 over the warmup, then
    a cosine from lr down to 0.1 lr at `total_steps`, flat after."""
    peak, warmup = cfg.learning_rate, cfg.warmup_steps
    if count < warmup:
        return peak * count / warmup
    decay_steps = cfg.total_steps - warmup
    alpha = 0.1
    t = min(count - warmup, decay_steps)
    cosine = 0.5 * (1 + math.cos(math.pi * t / decay_steps))
    return peak * ((1 - alpha) * cosine + alpha)


def make_optimizer(params: List[Any], cfg: TrainConfig
                   ) -> Tuple[torch.optim.Optimizer,
                              torch.optim.lr_scheduler.LambdaLR]:
    """AdamW and its schedule, equal to the JAX trainer's optax
    `adamw(warmup_cosine_decay_schedule)`: decoupled weight decay scaled
    by the learning rate on every parameter, eps outside the square
    root.  The global-norm clip that precedes it in the optax chain is
    `clip_by_global_norm_`, applied by the train step.  `params`: the
    parameters, or param groups of them (dicts, as torch.optim takes),
    all on the one schedule."""
    if cfg.total_steps <= cfg.warmup_steps:
        raise ValueError(f'total_steps {cfg.total_steps} must exceed '
                         f'warmup_steps {cfg.warmup_steps} (optax requires '
                         f'positive cosine decay steps)')
    optimizer = torch.optim.AdamW(params, lr=cfg.learning_rate,
                                  betas=(cfg.b1, cfg.b2), eps=1e-8,
                                  weight_decay=cfg.weight_decay)
    schedule = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda count: learning_rate(cfg, count) /
        cfg.learning_rate)
    return optimizer, schedule


def clip_by_global_norm_(grads: List[torch.Tensor],
                         max_norm: float,
                         norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """optax.clip_by_global_norm in place, on the device: g if the global
    norm is below `max_norm`, else g * max_norm / norm.  `norm`: the
    global norm when `grads` are shards of the tree (default: theirs).
    Returns the pre-clip norm (a device tensor)."""
    if norm is None:
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    torch._foreach_mul_(grads, factor)
    return norm


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token CE.  tokens [B, S]; logits [B, S, V] (predicting t+1)."""
    targets = tokens[:, 1:].long()
    logits = logits[:, :-1].float()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; a plain tensor (an expert weight) as is."""
    return t.to_local() if hasattr(t, 'to_local') else t


class ShardedLayout:
    """How a Llama on `mesh` trains: the FSDP2 mesh, the groups the step
    reduces over, which parameters are tensor-parallel slices and which
    are expert weights."""

    def __init__(self, model: nn.Module, mesh) -> None:
        shape = mesh.shape
        self.mesh = mesh
        self.train_mesh = mesh.train_mesh()
        self.fsdp_mesh = mesh.fsdp_mesh()
        self.shard_group = self.train_mesh.get_group('shard')
        self.replicate_group = self.train_mesh.get_group('replicate')
        self.tensor_group = mesh.group('tensor')
        self.context_parallel = model.cfg.attention_impl == 'ring'
        # FSDP averages every gradient over this many ranks.  The batch
        # is not split over 'pipeline', so each row is on that many
        # ranks; under context parallelism the 'expert' ranks of a row
        # block also hold the same tokens (rows split over dcn and data
        # only).
        self.n_avg = self.fsdp_mesh.size()
        self.dup = shape['pipeline'] * (shape['expert']
                                        if self.context_parallel else 1)
        # Parameter name -> the dim split over 'tensor' (None: whole).
        from skypilot_tpu_torch.models.llama import param_shapes
        self.tensor_dim: Dict[str, Optional[int]] = {}
        for name, full in param_shapes(model.cfg).items():
            dims = [d for d, axes in enumerate(
                sharding.tensor_spec(name, full, shape)) if axes == 'tensor']
            self.tensor_dim[name] = (dims[0] if dims and shape['tensor'] > 1
                                     else None)
        self.expert_names = {name for name in self.tensor_dim
                             if sharding.is_expert_param(name)}
        if self.expert_names:
            if self.context_parallel and shape['expert'] > 1:
                raise ValueError('a MoE model under ring attention trains '
                                 'at expert=1 (the expert ranks of a row '
                                 'block hold the same tokens)')
            self.expert_mesh = mesh.expert_mesh()
            self.expert_group = mesh.group('expert')
            self.expert_replicate_group = self.expert_mesh.get_group(
                'replicate')

    def global_view(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """The FSDP shard `t` (a DTensor over `fsdp_mesh`) of parameter
        `name`, or of one of its AdamW moments, as a DTensor of the whole
        parameter over `train_mesh` (sharing `t`'s storage): what a
        checkpoint saves and restores onto any plan.  An expert weight's
        slice (a plain tensor) becomes a DTensor over `expert_mesh`."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        dim = self.tensor_dim[name]
        shape = list(t.shape)
        if dim is not None:
            shape[dim] *= self.mesh.shape['tensor']
        tensor_place = Replicate() if dim is None else Shard(dim)
        if name in self.expert_names:
            shape[0] *= self.mesh.shape['expert']
            mesh, local = self.expert_mesh, t.detach()
            placements = [tensor_place, Shard(0), Replicate()]
        else:
            mesh, local = self.train_mesh, t.detach().to_local()
            placements = [tensor_place, *t.placements]
        stride = [math.prod(shape[i + 1:]) for i in range(len(shape))]
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=tuple(stride))

    def reduce_expert_grads(self, named_grads) -> None:
        """Each expert weight's gradient summed over the ranks holding
        the same experts, over the count FSDP divides the others by."""
        grads = [g for name, g in named_grads if name in self.expert_names]
        if not grads:
            return
        if dist.get_world_size(self.expert_replicate_group) > 1:
            for g in grads:
                dist.all_reduce(g, group=self.expert_replicate_group)
        torch._foreach_div_(grads, float(self.n_avg))

    def global_norm(self, named_grads) -> torch.Tensor:
        """The norm of the whole gradient tree from this rank's shards."""
        parts = {key: [] for key in ('split', 'whole', 'expert split',
                                     'expert whole')}
        for name, g in named_grads:
            key = 'whole' if self.tensor_dim[name] is None else 'split'
            if name in self.expert_names:
                key = 'expert ' + key
            parts[key].append(_local(g))

        def sum_sq(keys):
            return torch.stack([
                torch.stack(torch._foreach_norm(parts[k])).square().sum()
                if parts[k] else torch.zeros((), device=self.mesh.device)
                for k in keys]).float()

        # [split, whole]: FSDP shards, then the expert slices.
        sq = sum_sq(('split', 'whole'))
        if dist.get_world_size(self.shard_group) > 1:
            dist.all_reduce(sq, group=self.shard_group)
        if self.expert_names:
            expert_sq = sum_sq(('expert split', 'expert whole'))
            if dist.get_world_size(self.expert_group) > 1:
                dist.all_reduce(expert_sq, group=self.expert_group)
            sq = sq + expert_sq
        split_sq = sq[:1].clone()
        if dist.get_world_size(self.tensor_group) > 1:
            dist.all_reduce(split_sq, group=self.tensor_group)
        return (split_sq[0] + sq[1]).sqrt()

    def sum_over_replicas(self, t: torch.Tensor) -> torch.Tensor:
        """`t` summed over every rank of this rank's FSDP mesh."""
        for group in (self.shard_group, self.replicate_group):
            if dist.get_world_size(group) > 1:
                dist.all_reduce(t, group=group)
        return t


@dataclasses.dataclass
class TrainState:
    """What a train step updates in place, and what a checkpoint holds;
    `layout` is set for a model sharded over a mesh."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: torch.optim.lr_scheduler.LambdaLR
    step: torch.Tensor          # int64 scalar on the model's device
    layout: Optional[ShardedLayout] = None

    @property
    def device(self) -> torch.device:
        return self.step.device

    def state_dict(self) -> Dict[str, Any]:
        return {'params': self.model.state_dict(),
                'optimizer': self.optimizer.state_dict(),
                'schedule': self.schedule.state_dict(),
                'step': self.step}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state['params'])
        self.optimizer.load_state_dict(state['optimizer'])
        self.schedule.load_state_dict(state['schedule'])
        self.step.copy_(state['step'])


def make_train_state(model: nn.Module,
                     train_cfg: Optional[TrainConfig] = None,
                     mesh: Any = None) -> TrainState:
    """Turn gradients on for `model` and build its optimizer state on the
    model's device.  Under `mesh` (the mesh `model` was built on), shard
    it with FSDP2 first: each block, then the root, over the mesh's
    ('replicate', 'shard') sub-mesh."""
    model.requires_grad_(True)
    device = device_of(model)
    layout = None
    if mesh is not None:
        if getattr(model, 'mesh', None) is not mesh:
            raise ValueError('shard a model built on the same mesh '
                             '(Llama(cfg, params, mesh))')
        from torch.distributed.fsdp import fully_shard
        layout = ShardedLayout(model, mesh)
        experts = [p for name, p in model.named_parameters()
                   if name in layout.expert_names]
        for module in (*model.layers, model):
            fully_shard(module, mesh=layout.fsdp_mesh,
                        ignored_params=set(experts) or None)
    params = list(model.parameters())
    if layout is not None and experts:
        # foreach AdamW takes one kind of tensor a group (torch 2.11 refuses
        # plain tensors beside DTensors): the expert weights get their own.
        ids = {id(p) for p in experts}
        params = [{'params': [p for p in params if id(p) not in ids]},
                  {'params': experts}]
    optimizer, schedule = make_optimizer(params, train_cfg or TrainConfig())
    return TrainState(model, optimizer, schedule,
                      torch.zeros((), dtype=torch.int64, device=device),
                      layout)


def make_train_step(
    train_cfg: Optional[TrainConfig] = None,
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = lm_loss,
) -> Callable[[TrainState, torch.Tensor], Tuple[TrainState, dict]]:
    """The single-device train step: loss and gradients, the global-norm
    clip, one AdamW update and the schedule's tick, all in place."""
    cfg = train_cfg or TrainConfig()

    def step(state: TrainState, tokens: torch.Tensor):  # skytpu: hot-entry
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.model(tokens), tokens)
        loss.backward()
        grads = [p.grad for p in state.model.parameters()
                 if p.grad is not None]
        grad_norm = clip_by_global_norm_(grads, cfg.grad_clip)
        state.optimizer.step()
        state.schedule.step()
        state.step.add_(1)
        metrics = {'loss': loss.detach(), 'grad_norm': grad_norm,
                   'step': state.step.clone()}
        return state, metrics

    return step


def _context_loss(model: nn.Module, tokens: torch.Tensor, mesh
                  ) -> Tuple[torch.Tensor, int]:
    """(mean next-token CE, target count) of this rank's chunk under
    context parallelism: the chunk's targets are the next positions of
    the whole sequence, so its last target is the next chunk's first
    token; the last chunk has one target fewer."""
    inputs = sharding.context_slice(tokens, mesh)
    targets = sharding.context_slice(tokens.roll(-1, dims=1), mesh)
    n_t = inputs.shape[1] - (mesh.coordinate('fsdp') ==
                             mesh.shape['fsdp'] - 1)
    if n_t < 1:
        raise ValueError('a context-parallel chunk needs 2 positions or '
                         'more')
    logits = model(inputs)[:, :n_t].float()
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets[:, :n_t].reshape(-1).long())
    return loss, inputs.shape[0] * n_t


def make_sharded_train_step(
    mesh,
    train_cfg: Optional[TrainConfig] = None,
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = lm_loss,
) -> Callable[[TrainState, torch.Tensor], Tuple[TrainState, dict]]:
    """The train step of a state sharded over `mesh` (make_train_state
    with `mesh`), called on every rank with the same GLOBAL batch
    [B, S]: the loss and gradients of the global mean, the clip on the
    global norm, AdamW on the shards and the schedule's tick.  `loss_fn`
    is a mean over its rows (lm_loss); ring attention takes lm_loss
    only."""
    cfg = train_cfg or TrainConfig()

    def step(state: TrainState, tokens: torch.Tensor):  # skytpu: hot-entry
        layout = state.layout
        if layout is None or layout.mesh is not mesh:
            raise ValueError('the state is not sharded over this mesh')
        state.optimizer.zero_grad(set_to_none=True)
        tokens = tokens.to(mesh.device)
        n_total = tokens.shape[0] * (tokens.shape[1] - 1)
        if layout.context_parallel:
            if loss_fn is not lm_loss:
                raise ValueError('ring attention trains on lm_loss')
            local, n_local = _context_loss(state.model, tokens, mesh)
        else:
            rows = sharding.batch_slice(tokens, mesh)
            local = loss_fn(state.model(rows), rows)
            n_local = rows.shape[0] * (rows.shape[1] - 1)
        # FSDP averages over n_avg ranks: this weight makes the average
        # the gradient of the global mean.
        (local * (n_local * layout.n_avg / (n_total * layout.dup))
         ).backward()
        with torch.no_grad():
            loss = layout.sum_over_replicas(
                local.detach() * n_local) / (n_total * layout.dup)
            named = [(n, p.grad) for n, p in state.model.named_parameters()
                     if p.grad is not None]
            layout.reduce_expert_grads(named)
            norm = layout.global_norm(named)
            grad_norm = clip_by_global_norm_([_local(g) for _, g in named],
                                             cfg.grad_clip, norm)
        state.optimizer.step()
        state.schedule.step()
        state.step.add_(1)
        metrics = {'loss': loss, 'grad_norm': grad_norm,
                   'step': state.step.clone()}
        return state, metrics

    return step


def _fetch(metrics: dict) -> dict:
    """The metrics' values on the host in ONE device->host copy (the
    JAX trainer's device_get of the tree): float64 holds every f32 value
    and integer step exactly, and integer metrics come back as ints."""
    if not metrics:
        return {}
    flat = torch.stack([v.detach().reshape(()).to(torch.float64)
                        for v in metrics.values()])
    # skytpu: allow-sync(log-boundary and end-of-run read only: one copy of the metrics of a step already dispatched)
    host = flat.cpu().tolist()
    return {k: (x if v.is_floating_point() else int(x))
            for (k, v), x in zip(metrics.items(), host)}


class Trainer:
    """Minimal training loop: steps, metrics, periodic checkpointing."""

    def __init__(self, model: nn.Module,
                 train_cfg: Optional[TrainConfig] = None,
                 checkpoint_dir: Optional[str] = None,
                 phases=None,
                 host: Optional[str] = None,
                 device: DeviceLike = None,
                 mesh: Any = None) -> None:
        """`mesh`: train sharded over it (every rank of the mesh builds a
        Trainer and runs the same steps on the same global batches);
        the device is then the mesh's."""
        # Goodput phase recorder, opened before the optimizer state is
        # built so set-up lands in init_compile, not unclassified.
        self.phases = (phases if phases is not None
                       else goodput_lib.PhaseRecorder.from_env())
        self.phases.begin(goodput_lib.INIT_COMPILE)
        self.mesh = mesh
        rank = dist.get_rank() if mesh is not None else 0
        self.host = host if host is not None else f'host{rank}'
        self.device = resolve_device(mesh.device if mesh is not None and
                                     device is None else device)
        model_device = device_of(model)
        if model_device != self.device:
            raise ValueError(f'model parameters are on {model_device}, the '
                             f'trainer runs on {self.device}; move the '
                             f'model first')
        self._badput_exported: dict = {}
        self.model = model
        self.train_cfg = train_cfg or TrainConfig()
        self.state = make_train_state(model, self.train_cfg, mesh)
        self.train_step = (make_train_step(self.train_cfg) if mesh is None
                           else make_sharded_train_step(mesh,
                                                        self.train_cfg))
        self.checkpoint_dir = checkpoint_dir
        self._ckpt_mgr = None
        if checkpoint_dir is not None:
            self._ckpt_mgr = ckpt_lib.CheckpointManager(checkpoint_dir)

    def restore_if_available(self) -> int:
        """Resume from the newest checkpoint (preemption recovery path:
        managed jobs rely on this after a slice is recreated)."""
        if self._ckpt_mgr is None:
            return 0
        step = self._ckpt_mgr.latest_step()
        if step is None:
            return 0
        self.phases.begin(goodput_lib.CHECKPOINT_RESTORE)
        self.state = self._ckpt_mgr.restore(step, self.state)
        self.phases.begin(goodput_lib.INIT_COMPILE)
        return step

    def run(self, data: Iterator[torch.Tensor],  # skytpu: hot-entry
            num_steps: int,
            checkpoint_every: int = 0,
            log_every: int = 10,
            log_fn: Callable[[dict], None] = None) -> dict:
        gp = goodput_lib
        phases = self.phases
        metrics = {}
        batch = None
        t0 = time.perf_counter()
        tokens_seen = 0
        prev = t0
        # Gauges export WINDOWED throughput (since the last log
        # boundary); the cumulative average returned below would mask a
        # mid-run stall and keeps step 0's warm-up in its denominator.
        window_tokens = 0
        window_start = t0
        if phases.category != gp.INIT_COMPILE:
            phases.begin(gp.INIT_COMPILE, t0)
        # Non-productive seconds of THIS run (warm-up step, checkpoint
        # saves, input stalls), subtracted from every throughput
        # denominator.
        nonprod_s = 0.0
        window_nonprod = 0.0
        window_stall = 0.0
        for i in range(num_steps):
            fetch_t = time.perf_counter()
            batch = next(data).to(self.device, non_blocking=True)
            stall = time.perf_counter() - fetch_t
            tokens_seen += batch.numel()
            window_tokens += batch.numel()
            self.state, metrics = self.train_step(self.state, batch)
            # Host wall time per iteration: kernels are queued
            # asynchronously, and the caching allocator and the launch
            # queue hold the host to the device's pace at steady state;
            # no sync is added here.
            now = time.perf_counter()
            if i > 0:
                window_stall += stall
                metrics_lib.observe_hist('skytpu_train_step_seconds',
                                         now - prev, host=self.host)
            else:
                # Step 0 carries the kernel build, cuBLAS heuristics and
                # the allocator's growth; one such sample would inflate
                # the histogram and the first throughput window.
                window_tokens = 0
                window_start = now
                nonprod_s += now - t0
                phases.begin(gp.PRODUCTIVE, now)
            if checkpoint_every and (i + 1) % checkpoint_every == 0:
                ck0 = time.perf_counter()
                phases.begin(gp.CHECKPOINT_SAVE, ck0)
                self.save_checkpoint()
                ck1 = time.perf_counter()
                phases.begin(gp.PRODUCTIVE, ck1)
                nonprod_s += ck1 - ck0
                window_nonprod += ck1 - ck0
            if (i + 1) % log_every == 0:
                # Gauges export on every boundary, log_fn or not.
                phases.carve(gp.INPUT_STALL, window_stall)
                nonprod_s += window_stall
                window_nonprod += window_stall
                elapsed = time.perf_counter() - window_start
                self._export_throughput(
                    window_tokens / max(elapsed - window_nonprod, 1e-9),
                    batch)
                self._export_goodput()
                if log_fn:
                    # Log-boundary read only: the one host sync of the
                    # window.
                    m = _fetch(metrics)
                    m['tokens_per_s'] = tokens_seen / max(
                        time.perf_counter() - t0 - nonprod_s, 1e-9)
                    log_fn(m)
                window_tokens = 0
                window_stall = 0.0
                window_nonprod = 0.0
                window_start = time.perf_counter()
            # Re-stamp AFTER checkpoint/log work: a multi-second save
            # attributed to the next step would spike the step-time p99.
            prev = time.perf_counter()
        phases.carve(gp.INPUT_STALL, window_stall)
        nonprod_s += window_stall
        window_nonprod += window_stall
        # End of run: the final metrics fetch waits for the last step.
        out = _fetch(metrics)
        end = time.perf_counter()
        # Roll (flush) the open interval at run end.
        if phases.category is not None:
            phases.begin(phases.category, end)
        out['tokens_per_s'] = tokens_seen / max(end - t0 - nonprod_s,
                                                1e-9)
        if window_tokens:
            self._export_throughput(
                window_tokens / max(end - window_start - window_nonprod,
                                    1e-9),
                batch)
        self._export_goodput()
        return out

    def _export_goodput(self) -> None:
        """Goodput gauge + badput counter deltas from the recorder's
        live snapshot (no sync)."""
        snap = self.phases.snapshot()
        wall = sum(snap.values())
        if wall <= 0:
            return
        metrics_lib.set_gauge(
            metrics_lib.TRAIN_GOODPUT_FAMILY,
            100.0 * snap.get(goodput_lib.PRODUCTIVE, 0.0) / wall)
        for cat in goodput_lib.BADPUT_CATEGORIES:
            total = snap.get(cat, 0.0)
            delta = total - self._badput_exported.get(cat, 0.0)
            if delta > 0:
                metrics_lib.inc_counter(metrics_lib.TRAIN_BADPUT_FAMILY,
                                        delta, category=cat)
                self._badput_exported[cat] = total

    def _export_throughput(self, tokens_per_s: float, batch) -> None:
        """tokens/sec + estimated-MFU gauges (train/flops.py's FLOP
        accounting against this device's peak).  Models without a
        LlamaConfig-shaped cfg just skip the MFU gauge."""
        metrics_lib.set_gauge('skytpu_train_tokens_per_second',
                              tokens_per_s)
        cfg = getattr(self.model, 'cfg', None)
        if batch is None or cfg is None:
            return
        try:
            n_params = cfg.num_params()
            mfu = flops_lib.estimate_mfu(
                tokens_per_s, n_params, cfg.n_layers, cfg.dim,
                seq_len=batch.shape[-1],
                n_chips=1 if self.mesh is None else self.mesh.size,
                kind=flops_lib.chip_kind(self.device))
        except (AttributeError, TypeError):
            return      # cfg not LlamaConfig-shaped: no MFU gauge
        if mfu > 0:
            metrics_lib.set_gauge('skytpu_train_mfu_percent', mfu)
        tokens_per_step = int(batch.numel())
        hbm_bytes = flops_lib.train_hbm_bytes_per_token(
            n_params, tokens_per_step)
        if hbm_bytes > 0:
            metrics_lib.set_gauge('skytpu_train_hbm_bytes_per_token',
                                  hbm_bytes)
            metrics_lib.set_gauge(
                'skytpu_train_arith_intensity',
                flops_lib.train_arith_intensity(
                    n_params, cfg.n_layers, cfg.dim,
                    seq_len=batch.shape[-1],
                    tokens_per_step=tokens_per_step))

    def save_checkpoint(self) -> None:
        if self._ckpt_mgr is not None:
            # skytpu: allow-sync(checkpoint boundary: the whole state is copied to the host anyway, so reading the step adds nothing)
            self._ckpt_mgr.save(int(self.state.step.item()), self.state)
