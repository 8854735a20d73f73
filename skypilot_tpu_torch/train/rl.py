"""RL fine-tuning primitives: policy-gradient updates over sampled
continuations (PyTorch).

Twin of `skypilot_tpu/train/rl.py`, the same loop on one device:
- ROLLOUT on the serving engine (inference/engine.py): sampling runs in
  the continuous-batching decode loop (temperature > 0), whose decode
  call is one CUDA graph on the card;
- UPDATE with one REINFORCE step: a masked log-prob loss whose forward
  is a teacher-forced pass over [prompt + sampled] (attention through
  the flash autograd op: the forward, dq and dk/dv kernels on the card);
- advantages are plain host arrays (reward whitening happens host-side
  where reward functions live);
- SWAP with `engine.update_params` WITHOUT draining: the learner's
  state dict is copied onto the engine and installed at the decode
  loop's next dispatch boundary.  The engine always copies, so the
  learner keeps its own tensors, which its optimizer updates in place.

PPO ratios and KL penalties compose on top by passing `ref_logprobs`.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from skypilot_tpu_torch.device import device_of


def sequence_logprobs(logits: torch.Tensor,
                      tokens: torch.Tensor) -> torch.Tensor:
    """Per-position log p(tokens[t] | tokens[<t]) from next-token
    logits: logits[:, t] predicts tokens[:, t+1].  Returns [B, S-1] f32."""
    logp = F.log_softmax(logits[:, :-1].float(), dim=-1)
    return torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]


def reinforce_loss(logits: torch.Tensor, tokens: torch.Tensor,
                   advantages: torch.Tensor, prompt_lens: torch.Tensor,
                   total_lens: torch.Tensor,
                   ref_logprobs: Optional[torch.Tensor] = None,
                   kl_coef: float = 0.0) -> torch.Tensor:
    """REINFORCE objective over each row's SAMPLED region only.

    tokens [B, S] = prompt + sampled continuation, zero-padded to S
    (teacher-forced); advantages [B] (whitened rewards); prompt_lens and
    total_lens are PER-ROW [B]: rows may differ in prompt and
    continuation length, and padding beyond total_lens never reaches the
    gradient.  Optional KL regularization toward a reference policy's
    per-token logprobs [B, S-1] (PPO-lite)."""
    logprobs = sequence_logprobs(logits, tokens)              # [B, S-1]
    positions = torch.arange(tokens.shape[1] - 1,
                             device=tokens.device)[None, :]
    mask = ((positions >= prompt_lens[:, None] - 1) &
            (positions < total_lens[:, None] - 1)).to(logprobs.dtype)
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = -(advantages[:, None].float() * logprobs * mask).sum() / denom
    if ref_logprobs is not None and kl_coef > 0.0:
        kl = ((logprobs - ref_logprobs) * mask).sum() / denom
        loss = loss + kl_coef * kl
    return loss


def whiten(rewards) -> np.ndarray:
    """Standard advantage whitening (mean 0, std 1; std floor for the
    all-equal case)."""
    rewards = np.asarray(rewards, np.float32)
    return (rewards - rewards.mean()) / max(float(rewards.std()), 1e-6)


def make_reinforce_step(model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer,
                        kl_coef: float = 0.0) -> Callable[..., torch.Tensor]:
    """The REINFORCE update of `model` by `optimizer` (built over
    `model.parameters()`; e.g. `torch.optim.Adam` for the JAX recipe's
    `optax.adam`): `step(tokens, advantages, prompt_lens, total_lens,
    ref_logprobs=None)` takes one gradient step in place and returns the
    loss (a device tensor, not read back).  Inputs may be numpy arrays
    or tensors; they are moved to the model's device.  Turns gradients
    on for `model`."""
    model.requires_grad_(True)
    device = device_of(model)

    def as_tensor(x, dtype=None):
        # Host inputs go up from pinned memory without blocking: a
        # pageable copy would wait for the device's queue to drain.
        t = torch.as_tensor(x, dtype=dtype)
        if device.type == 'cuda' and t.device.type == 'cpu':
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    def step(tokens, advantages, prompt_lens,  # skytpu: hot-entry
             total_lens, ref_logprobs=None) -> torch.Tensor:
        tokens = as_tensor(tokens, torch.long)
        optimizer.zero_grad(set_to_none=True)
        loss = reinforce_loss(
            model(tokens), tokens, as_tensor(advantages, torch.float32),
            as_tensor(prompt_lens, torch.long),
            as_tensor(total_lens, torch.long),
            None if ref_logprobs is None else as_tensor(ref_logprobs),
            kl_coef)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def rollout(engine,  # skytpu: hot-entry
            prompts: List[List[int]], max_new_tokens: int,
            reward_fn: Callable[[List[int], List[int]], float]
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Sample continuations on the decode engine and score them.

    Returns (tokens [B, S] zero-padded, advantages [B], prompt_lens [B],
    total_lens [B]): per-row lengths feed reinforce_loss's mask so
    padding and unequal prompts never reach the gradient.  The engine
    must sample (temperature > 0): greedy rollouts collapse the policy
    gradient to a point mass."""
    reqs = [engine.submit(p, max_new_tokens) for p in prompts]
    while any(r.finished_at is None for r in reqs):
        engine.step_pipelined()
    # No drain: the retire-lag call left in flight is garbage the next
    # rollout's first step discards, and update_params needs no idle
    # engine (the swap installs at the next dispatch boundary).
    sampled = [r.tokens() for r in reqs]
    rewards = [reward_fn(p, s) for p, s in zip(prompts, sampled)]
    prompt_lens = np.asarray([len(p) for p in prompts], np.int32)
    total_lens = np.asarray(
        [len(p) + len(s) for p, s in zip(prompts, sampled)], np.int32)
    tokens = np.zeros((len(prompts), int(total_lens.max())), np.int32)
    for i, (p, s) in enumerate(zip(prompts, sampled)):
        seq = list(p) + list(s)
        tokens[i, :len(seq)] = seq
    return tokens, whiten(rewards), prompt_lens, total_lens
