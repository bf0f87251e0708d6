"""The trainer's optimizer: the optax chain of ``lapha_tpu/train/trainer.py``
(:177-207), written out in PyTorch.

In order, on the list of leaves of (params, head):
  clip_by_global_norm(max_grad_norm)
  scale_by_adam(b1, b2, eps=1e-8, mu_dtype=f32)   mu in f32, nu in the leaf dtype
  add_decayed_weights(weight_decay)                 only when weight_decay > 0
  scale_by_learning_rate(schedule)                  warmup-cosine, linear or constant
and, with ``every_k > 1``, the whole chain inside ``optax.MultiSteps``: the
gradients of k calls are averaged (Welford, in the leaf dtype) and the chain
applies on every k-th call, the others leaving the params unchanged.

``torch.optim.AdamW`` would keep both moments in the parameter dtype (bf16
for bf16 weights) and fold the decay in differently, so it would not follow
the JAX trainer; this follows optax's arithmetic and dtypes step by step
(held to it by test). The update is applied in place under ``no_grad``.
The state is a dict of tensors and ints (``torch.save``-able).

The global norm and the update run over each leaf in flat slices of at
most ``SLICE`` elements, so that no f32 copy of a whole leaf is ever made:
an MoE expert stack holds billions of elements (GPT-OSS-20B's gate_up is
2.1e9 in 4 layers, 8.5 GB in f32 per temporary). The arithmetic of every
element is the one of the whole-leaf form; only the f32 sum of the global
norm is taken in another order.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[int], float]

SLICE = 1 << 27  # elements per slice of a leaf (512 MB of f32 temporaries)


def _flat_slices(t: torch.Tensor, inplace: bool = True) -> list[torch.Tensor]:
    """Views of ``t``, flattened, in slices of at most SLICE elements. A
    tensor written through them must be contiguous (``view`` raises
    otherwise); one only read (``inplace`` False) may be copied to flatten."""
    return list((t.view(-1) if inplace else t.reshape(-1)).split(SLICE))


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ g²) over every leaf, summed in f32, slice by slice."""
    return torch.sqrt(sum((s.float() ** 2).sum() for g in grads
                          for s in _flat_slices(g, inplace=False)))


# ----------------------------------------------------------------- schedules (optax)

def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count):
        frac = 1 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count):
        c = min(count, decay_steps)
        return init_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps)) + alpha)

    return schedule


def constant_schedule(value: float) -> Schedule:
    return lambda count: value


def join_schedules(schedules: list[Schedule], boundaries: list[int]) -> Schedule:
    def schedule(count):
        out = schedules[0](count)
        for boundary, s in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = s(count - boundary)
        return out

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Schedule:
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return join_schedules([linear_schedule(init_value, peak_value, warmup_steps),
                           cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)],
                          [warmup_steps])


def trainer_schedule(kind: str, lr: float, warmup: int, total_steps: int) -> Schedule:
    """The JAX trainer's schedule for ``lr_scheduler_type``."""
    if kind == "cosine":
        return warmup_cosine_decay_schedule(0.0, lr, warmup, max(total_steps, warmup + 1))
    if kind == "linear":  # transformers-style: warmup to lr, linear decay to 0
        return join_schedules([linear_schedule(0.0, lr, warmup),
                               linear_schedule(lr, 0.0, max(1, total_steps - warmup))], [warmup])
    # "constant" and anything else: flat lr after warmup
    return join_schedules([linear_schedule(0.0, lr, warmup), constant_schedule(lr)], [warmup])


# ----------------------------------------------------------------- the chain

class AdamChain:
    """clip -> Adam (f32 mu) -> decayed weights -> -lr(schedule) [-> MultiSteps]."""

    def __init__(self, schedule: Schedule, *, max_grad_norm: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                 every_k: int = 1):
        self.schedule = schedule
        self.max_grad_norm = float(max_grad_norm)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.weight_decay = float(weight_decay)
        self.every_k = max(1, int(every_k))

    def init(self, leaves: list[torch.Tensor]) -> dict:
        state = {"count": 0, "sched_count": 0,
                 "mu": [torch.zeros_like(p, dtype=torch.float32) for p in leaves],
                 "nu": [torch.zeros_like(p) for p in leaves]}
        if self.every_k > 1:
            state.update(mini_step=0, gradient_step=0,
                         acc=[torch.zeros_like(p) for p in leaves])
        return state

    def _bias(self, decay: float, count: int) -> torch.Tensor:
        # 1 - decay**count in f32, as optax computes it before casting
        return 1 - torch.tensor(decay, dtype=torch.float32) ** count

    @torch.no_grad()
    def _inner(self, leaves, grads, state) -> None:
        g_norm = global_norm(grads)
        clip = not bool(g_norm < self.max_grad_norm)
        state["count"] += 1
        bc1 = self._bias(self.b1, state["count"])
        bc2 = self._bias(self.b2, state["count"])
        lr = torch.tensor(-self.schedule(state["sched_count"]), dtype=torch.float32)
        state["sched_count"] += 1
        for i, (leaf, grad) in enumerate(zip(leaves, grads)):
            for p, g, m, n in zip(_flat_slices(leaf), _flat_slices(grad, inplace=False),
                                  _flat_slices(state["mu"][i]), _flat_slices(state["nu"][i])):
                if clip:
                    g = (g / g_norm.to(g.dtype)) * self.max_grad_norm
                mu = (1 - self.b1) * g + self.b1 * m          # f32
                nu = (1 - self.b2) * (g * g) + self.b2 * n    # leaf dtype
                m.copy_(mu)
                n.copy_(nu)
                u = (mu / bc1.to(mu.device)) / (
                    torch.sqrt(nu / bc2.to(device=nu.device, dtype=nu.dtype)) + self.eps)
                if self.weight_decay > 0:
                    u = u + self.weight_decay * p
                u = u * lr.to(device=u.device, dtype=u.dtype)
                p.add_(u.to(p.dtype))

    @torch.no_grad()
    def apply(self, leaves: list[torch.Tensor], grads: list[torch.Tensor], state: dict) -> None:
        """One optimizer call: updates ``leaves`` and ``state`` in place."""
        if self.every_k == 1:
            self._inner(leaves, grads, state)
            return
        n = state["mini_step"]
        acc = [a + (g - a) / (n + 1) for a, g in zip(state["acc"], grads)]
        if n == self.every_k - 1:
            self._inner(leaves, acc, state)
            state["acc"] = [torch.zeros_like(a) for a in acc]
            state["gradient_step"] += 1
        else:
            state["acc"] = acc
        state["mini_step"] = (n + 1) % self.every_k


def build_trainer_optimizer(args, total_steps: int, warmup: int) -> AdamChain:
    """The JAX trainer's ``build_optimizer`` for an ``MTPOConfig``."""
    return AdamChain(trainer_schedule(args.lr_scheduler_type, args.learning_rate, warmup,
                                      total_steps),
                     max_grad_norm=args.max_grad_norm, b1=args.adam_beta1, b2=args.adam_beta2,
                     weight_decay=args.weight_decay,
                     every_k=args.gradient_accumulation_steps)
