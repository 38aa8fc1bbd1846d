"""Training step: CFM loss + AdamW + grad clip + NaN skip + EMA (counterpart
of `f5e_tts_tpu/train/step.py`).

reference training loop semantics: src/f5_tts/model/trainer.py:265-432.
The JAX package builds the update from optax; the port writes the same
chain by hand on lists of fp32 master tensors, updated in place:

    MultiSteps(chain(clip_by_global_norm(max_grad_norm),
                     adamw(schedule, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0)),
               every_k=grad_accumulation_steps)

- MultiSteps keeps the running MEAN of the micro-gradients (acc += (g - acc)
  / (n + 1)) and applies the inner update on every k-th micro-step;
- the clip scales by max_norm / g_norm only when g_norm >= max_norm (no eps);
- the schedule is evaluated at the count of updates applied before this one.

Counters: `micro` counts successful micro-steps, `update` counts optimizer
updates (micro / grad_accumulation), `skipped` counts NaN-skipped
micro-steps. A micro-step whose loss or gradient norm is not finite leaves
the params, the optimizer state, the accumulators, the model state (a PPG
DiT's BatchNorm statistics) and the EMA untouched: it is checked before
anything is updated in place. The EMA covers the params only, as in JAX.

EMA follows ema_pytorch (the reference constructs EMA(model) with defaults,
trainer.py:104): the n-th optimizer update invokes EMA.update() with the
pre-increment step n-1; calls are gated to step % update_every == 0; a hard
copy while step <= update_after_step + update_every (the warm copies plus
ema_pytorch's `initted` copy); afterwards the decay
1 - (1 + epoch / inv_gamma)^(-power), epoch = n - update_after_step - 1,
clamped to [min_value, beta].
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, NamedTuple, Optional

import torch

from f5e_tts_tpu_torch.config import CFMConfig, TrainConfig
from f5e_tts_tpu_torch.models import cfm as fcfm


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict/list tree, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """fn over the tensors of a nested dict/list tree; other leaves kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors, fp32 scalar (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)).float())


class EMASettings(NamedTuple):
    """ema_pytorch constructor defaults (reference trainer.py:104)."""

    beta: float = 0.9999
    update_after_step: int = 100
    update_every: int = 10
    inv_gamma: float = 1.0
    power: float = 2.0 / 3.0
    min_value: float = 0.0

    @classmethod
    def from_train_cfg(cls, tc: TrainConfig) -> "EMASettings":
        return cls(beta=tc.ema_beta, update_after_step=tc.ema_update_after_step,
                   update_every=tc.ema_update_every, inv_gamma=tc.ema_inv_gamma,
                   power=tc.ema_power, min_value=tc.ema_min_value)


def ema_decay_at(update: int, ema: EMASettings) -> float:
    """Decay used by the `update`-th optimizer update (1-indexed): 0 while
    epoch = update - update_after_step - 1 <= 0, else
    clamp(1 - (1 + epoch / inv_gamma)^-power, min_value, beta)."""
    epoch = max(update - ema.update_after_step - 1.0, 0.0)
    if epoch <= 0.0:
        return 0.0
    value = 1.0 - (1.0 + epoch / ema.inv_gamma) ** (-ema.power)
    return min(max(value, ema.min_value), ema.beta)


def make_schedule(train: TrainConfig, total_updates: int,
                  num_replicas: int = 1) -> Callable[[int], float]:
    """Linear warmup from 1e-8 to the peak over num_warmup_updates x
    num_replicas updates (the warmup scales with the data-parallel replica
    count, trainer.py:316-318), then linear decay to 1e-8 over the rest
    (optax.join_schedules of two linear_schedules, trainer.py:334-340)."""
    lr = train.learning_rate
    warmup = train.num_warmup_updates * num_replicas
    decay = max(total_updates - warmup, 1)

    def linear(init: float, end: float, steps: int, count: int) -> float:
        if steps <= 0:
            return init
        return (init - end) * (1.0 - min(max(count, 0), steps) / steps) + end

    def schedule(count: int) -> float:
        if count < warmup:
            return linear(1e-8, lr, warmup, count)
        return linear(lr, 1e-8, decay, count - warmup)

    return schedule


@dataclass
class AdamWState:
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    count: int = 0  # applied updates
    acc: Optional[List[torch.Tensor]] = None  # running mean of micro-gradients
    mini_step: int = 0

    def state_dict(self) -> dict:
        return {"mu": self.mu, "nu": self.nu, "count": self.count, "acc": self.acc,
                "mini_step": self.mini_step}


class AdamW:
    """The optax chain of the module docstring, in place on lists of fp32
    tensors (torch._foreach ops, one launch per op over all tensors)."""

    def __init__(self, schedule: Callable[[int], float], max_grad_norm: float,
                 grad_accum: int = 1, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.schedule, self.max_grad_norm, self.grad_accum = schedule, max_grad_norm, grad_accum
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: List[torch.Tensor]) -> AdamWState:
        zeros = lambda: [torch.zeros_like(p, dtype=torch.float32) for p in params]  # noqa: E731
        return AdamWState(mu=zeros(), nu=zeros(), acc=zeros() if self.grad_accum > 1 else None)

    @torch.no_grad()
    def update_(self, state: AdamWState, params: List[torch.Tensor],
                grads: List[torch.Tensor],
                norm_fn: Callable[[List[torch.Tensor]], torch.Tensor] = global_norm) -> bool:
        """One finite micro-step; True when it applied an optimizer update.
        `norm_fn` gives the clip's global norm (over the whole sharded
        gradient under a mesh: parallel/mesh.py: GradSync.norm)."""
        if state.acc is not None:
            n = state.mini_step
            diff = torch._foreach_sub(grads, state.acc)
            torch._foreach_div_(diff, float(n + 1))
            torch._foreach_add_(state.acc, diff)
            state.mini_step = (n + 1) % self.grad_accum
            if n != self.grad_accum - 1:
                return False
            grads = state.acc  # clipped in place below, then zeroed
        g_norm = float(norm_fn(grads))
        if not g_norm < self.max_grad_norm:
            torch._foreach_div_(grads, g_norm)
            torch._foreach_mul_(grads, self.max_grad_norm)
        self._adam_(state, params, grads)
        if state.acc is not None:
            torch._foreach_zero_(state.acc)
        return True

    @torch.no_grad()
    def _adam_(self, state: AdamWState, params: List[torch.Tensor],
               grads: List[torch.Tensor]) -> None:
        """optax.adamw on the clipped gradients, the schedule read at the
        count before this update."""
        lr = self.schedule(state.count)
        state.count += 1
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - b2)
        denom = torch._foreach_div(state.nu, 1.0 - b2 ** state.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(state.mu, 1.0 - b1 ** state.count)
        torch._foreach_div_(step, denom)
        torch._foreach_add_(params, step, alpha=-lr)


def make_optimizer(train: TrainConfig, total_updates: int, num_replicas: int = 1) -> AdamW:
    """The JAX optimizer chain; `bnb_optimizer` swaps AdamW for the
    block-wise 8-bit one (train/adamw8bit.py; reference trainer.py:134-137).
    `num_replicas` (data x fsdp) scales the warmup."""
    schedule = make_schedule(train, total_updates, num_replicas)
    if train.bnb_optimizer:
        from f5e_tts_tpu_torch.train.adamw8bit import AdamW8bit

        return AdamW8bit(schedule, train.max_grad_norm, train.grad_accumulation_steps)
    return AdamW(schedule, train.max_grad_norm, train.grad_accumulation_steps)


@dataclass
class TrainState:
    params: dict  # fp32 master weights, requires_grad
    ema_params: dict
    opt_state: AdamWState
    update: int = 0  # completed optimizer updates
    micro: int = 0  # completed micro-steps
    skipped: int = 0  # NaN-skipped micro-steps
    model_state: dict = field(default_factory=dict)  # a PPG DiT's BatchNorm running statistics


def init_train_state(params: dict, optimizer: AdamW, model_state: Optional[dict] = None
                     ) -> TrainState:
    params = tree_map(lambda t: t.detach().float().requires_grad_(True), params)
    ema = tree_map(lambda t: t.detach().clone(), params)
    return TrainState(params=params, ema_params=ema, opt_state=optimizer.init(tree_leaves(params)),
                      model_state=model_state or {})


class StepMetrics(NamedTuple):
    loss: float
    flow_loss: float
    grad_norm: float
    skipped: int
    extra_loss: float = 0.0  # the codebook losses, align + perplexity
    align_loss: float = 0.0
    perplex_loss: float = 0.0


@torch.no_grad()
def _ema_update_(ts: TrainState, ema: EMASettings) -> None:
    pre = ts.update - 1  # ema_pytorch's pre-increment call counter
    if pre % ema.update_every:
        return
    e, p = tree_leaves(ts.ema_params), tree_leaves(ts.params)
    if pre <= ema.update_after_step + ema.update_every:
        torch._foreach_copy_(e, p)
        return
    decay = ema_decay_at(ts.update, ema)
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, p, alpha=1.0 - decay)


def apply_gradients(ts: TrainState, out: fcfm.CFMLossOut, grads: List[torch.Tensor], *,
                    optimizer: AdamW, ema: EMASettings, sync=None):
    """The post-backward half of a step: NaN gate, optimizer, counters, model
    state, EMA. Updates `ts` in place and returns (ts, StepMetrics); the new
    model state is kept only when the step passes the gate (JAX step.py:140-148).
    `sync` (parallel/mesh.py: GradSync) under a mesh: the gradients are
    summed over the batch axes first, the norm of the clip and the gate is
    the whole gradient's, and the new model state the shards' mean."""
    norm_fn = global_norm
    if sync is not None:
        sync.reduce_(grads)
        norm_fn = sync.norm
    grad_norm = norm_fn(grads)
    ok = bool(torch.isfinite(out.loss) & torch.isfinite(grad_norm))
    if ok:
        if out.new_state:
            if sync is not None:
                sync.mean_(tree_leaves(out.new_state))
            ts.model_state = out.new_state
        leaves = tree_leaves(ts.params)
        # one device: any optimizer with update_(state, params, grads) (make_distill_step's)
        applied = (optimizer.update_(ts.opt_state, leaves, grads) if sync is None else
                   optimizer.update_(ts.opt_state, leaves, grads, norm_fn=norm_fn))
        ts.micro += 1
        if applied:
            ts.update += 1
            _ema_update_(ts, ema)
    else:
        ts.skipped += 1
    extra = [0.0 if v is None else float(v.detach())
             for v in (out.extra_loss, out.align_loss, out.perplex_loss)]
    return ts, StepMetrics(loss=float(out.loss.detach()), flow_loss=float(out.flow_loss.detach()),
                           grad_norm=float(grad_norm), skipped=int(not ok), extra_loss=extra[0],
                           align_loss=extra[1], perplex_loss=extra[2])


def backward_and_apply(ts: TrainState, loss_fn: Callable[[dict], fcfm.CFMLossOut], *,
                       optimizer: AdamW, ema: EMASettings, sync=None):
    """loss_fn(params) forward and backward into fresh gradients, then
    `apply_gradients`."""
    leaves = tree_leaves(ts.params)
    for p in leaves:
        p.grad = None
    out = loss_fn(ts.params)
    out.loss.backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in leaves]
    for p in leaves:
        p.grad = None
    return apply_gradients(ts, out, grads, optimizer=optimizer, ema=ema, sync=sync)


def train_step(ts: TrainState, batch: dict, *, arch, cfm: CFMConfig,
               optimizer: AdamW, ema: EMASettings = EMASettings(),
               generator: Optional[torch.Generator] = None,
               draws: Optional[fcfm.LossDraws] = None, compute_dtype=torch.bfloat16):
    """One micro-step on batch {mel (B, N, D), mel_lens, text_ids[, text_lens,
    ppg, ppg_lens]}; draws not given come from `generator`. Returns (ts,
    StepMetrics)."""
    def loss_fn(params):
        return fcfm.cfm_loss(params, arch, cfm, mel=batch["mel"], mel_lens=batch["mel_lens"],
                             text_ids=batch.get("text_ids"), generator=generator, draws=draws,
                             training=True, compute_dtype=compute_dtype, state=ts.model_state,
                             text_lens=batch.get("text_lens"), ppg=batch.get("ppg"),
                             ppg_lens=batch.get("ppg_lens"))

    return backward_and_apply(ts, loss_fn, optimizer=optimizer, ema=ema)
