"""Single-device training loop for decoder LMs (PyTorch).

Twin of `skypilot_tpu/train/trainer.py` on one device: the same
`TrainConfig`, the same loss (`lm_loss`, f32 next-token cross-entropy),
an optimizer equal to its optax chain (global-norm clip, then AdamW on a
warmup-cosine schedule), and a `Trainer` with the same phase stamping,
windowed throughput, MFU/HBM gauges and productive-time denominators.
Parameters and optimizer state are f32; the model computes in its
`cfg.dtype` (bf16 by default), attention through the flash kernels.

No step reads a value back to the host: `loss`, `grad_norm` and `step`
stay device tensors, fetched only at log boundaries and at the end of a
run, as the JAX trainer's `jax.device_get`.  Meshes and sharding rules
come with the multi-device port.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from skypilot_tpu_torch.device import DeviceLike, device_of, resolve_device
from skypilot_tpu_torch.obs import goodput as goodput_lib
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


def make_optimizer(params: List[nn.Parameter], cfg: TrainConfig
                   ) -> Tuple[torch.optim.Optimizer,
                              torch.optim.lr_scheduler.LambdaLR]:
    """AdamW and its schedule, equal to the JAX trainer's optax
    `adamw(warmup_cosine_decay_schedule)`: decoupled weight decay scaled
    by the learning rate on every parameter, eps outside the square
    root.  The global-norm clip that precedes it in the optax chain is
    `clip_by_global_norm_`, applied by the train step."""
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
                         max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place, on the device: g if the global
    norm is below `max_norm`, else g * max_norm / norm.  Returns the
    pre-clip norm (a device tensor)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
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


@dataclasses.dataclass
class TrainState:
    """What a train step updates in place, and what a checkpoint holds."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: torch.optim.lr_scheduler.LambdaLR
    step: torch.Tensor          # int64 scalar on the model's device

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
                     train_cfg: Optional[TrainConfig] = None) -> TrainState:
    """Turn gradients on for `model` and build its optimizer state on the
    model's device."""
    model.requires_grad_(True)
    device = device_of(model)
    optimizer, schedule = make_optimizer(list(model.parameters()),
                                         train_cfg or TrainConfig())
    return TrainState(model, optimizer, schedule,
                      torch.zeros((), dtype=torch.int64, device=device))


def make_train_step(
    train_cfg: Optional[TrainConfig] = None,
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = lm_loss,
) -> Callable[[TrainState, torch.Tensor], Tuple[TrainState, dict]]:
    """The single-device train step: loss and gradients, the global-norm
    clip, one AdamW update and the schedule's tick, all in place."""
    cfg = train_cfg or TrainConfig()

    def step(state: TrainState, tokens: torch.Tensor):
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


def _fetch(metrics: dict) -> dict:
    return {k: v.item() for k, v in metrics.items()}


class Trainer:
    """Minimal training loop: steps, metrics, periodic checkpointing."""

    def __init__(self, model: nn.Module,
                 train_cfg: Optional[TrainConfig] = None,
                 checkpoint_dir: Optional[str] = None,
                 phases=None,
                 host: Optional[str] = None,
                 device: DeviceLike = None) -> None:
        # Goodput phase recorder, opened before the optimizer state is
        # built so set-up lands in init_compile, not unclassified.
        self.phases = (phases if phases is not None
                       else goodput_lib.PhaseRecorder.from_env())
        self.phases.begin(goodput_lib.INIT_COMPILE)
        self.host = host if host is not None else 'host0'
        self.device = resolve_device(device)
        model_device = device_of(model)
        if model_device != self.device:
            raise ValueError(f'model parameters are on {model_device}, the '
                             f'trainer runs on {self.device}; move the '
                             f'model first')
        self._badput_exported: dict = {}
        self.model = model
        self.train_cfg = train_cfg or TrainConfig()
        self.state = make_train_state(model, self.train_cfg)
        self.train_step = make_train_step(self.train_cfg)
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

    def run(self, data: Iterator[torch.Tensor],
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
                seq_len=batch.shape[-1], n_chips=1,
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
            # Checkpoint boundary: the whole state is copied to the host
            # anyway, so reading the step adds nothing.
            self._ckpt_mgr.save(int(self.state.step.item()), self.state)
