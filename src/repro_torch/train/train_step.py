"""The training step: loss, gradients and the partitioned optimizer update
(``repro.train.train_step``).

Orthogonal leaves (``models.ortho.label_tree``) are updated by the
configured orthoptimizer (POGO by default, VAdam base, the fused CUDA
kernel with ``pogo_use_kernel``, the feasibility watchdog with
``ortho_watchdog``), every other leaf by AdamW. Microbatch gradient
accumulation is a Python loop. The step is functional, as in JAX: it
returns new params and a new optimizer state and leaves its inputs as
they were.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import torch

from .. import optim, tree
from ..core import api as core
from ..models import ortho
from ..models import transformer as tfm

PyTree = Any


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    pogo_learning_rate: float = 0.5  # the orthoptimizer's learning rate
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    # None = the method's own default; forwarded only to methods that
    # declare the field.
    pogo_lam: Optional[float] = None
    pogo_find_root: Optional[bool] = None
    pogo_use_kernel: bool = False
    pogo_base: str = "vadam"  # "vadam" | "sgd" | "momentum"
    microbatches: int = 1
    default_opt: str = "adamw"  # "adamw" | "adafactor"
    warmup_steps: int = 100
    decay_steps: int = 10000
    orthoptimizer: str = "pogo"
    ortho_kwargs: Optional[Mapping[str, Any]] = None
    ortho_seed: int = 0
    ortho_safety_project_every: int = 0
    ortho_grouping: str = "auto"
    ortho_watchdog: Optional[core.WatchdogConfig] = None


def make_optimizer(cfg, train_cfg: TrainConfig) -> optim.GradientTransformation:
    sched = optim.warmup_cosine(train_cfg.learning_rate, train_cfg.warmup_steps,
                                train_cfg.decay_steps)
    if train_cfg.default_opt == "adafactor":
        default_opt = optim.scale_by_adafactor()
    else:
        default_opt = optim.chain(
            optim.clip_by_global_norm(train_cfg.grad_clip),
            optim.scale_by_adam(),
            optim.add_decayed_weights(train_cfg.weight_decay),
            optim.scale_by_learning_rate(sched),
        )
    base = {
        "vadam": optim.chain(optim.scale_by_vadam()),
        "sgd": None,
        "momentum": optim.chain(optim.trace(0.9)),
    }[train_cfg.pogo_base]
    method_kwargs = core.method_overrides(
        train_cfg.orthoptimizer, lam=train_cfg.pogo_lam,
        find_root=train_cfg.pogo_find_root)
    extra = dict(train_cfg.ortho_kwargs or {})
    reserved = {f.name for f in dataclasses.fields(core.OrthoConfig)} & set(extra)
    if reserved:
        raise ValueError(
            f"ortho_kwargs may not set driver-level fields {sorted(reserved)}; "
            "use the dedicated TrainConfig fields (pogo_learning_rate, "
            "pogo_use_kernel, pogo_base, ortho_seed, "
            "ortho_safety_project_every, ortho_grouping, ortho_watchdog) "
            "instead"
        )
    method_kwargs.update(extra)
    ortho_opt = core.orthogonal(
        train_cfg.orthoptimizer,
        learning_rate=train_cfg.pogo_learning_rate,
        base_optimizer=base,
        use_kernel=train_cfg.pogo_use_kernel,
        safety_project_every=train_cfg.ortho_safety_project_every,
        seed=train_cfg.ortho_seed,
        grouping=train_cfg.ortho_grouping,
        watchdog=train_cfg.ortho_watchdog,
        **method_kwargs,
    )
    return optim.partition({"orthogonal": ortho_opt, "default": default_opt},
                           lambda params: ortho.label_tree(params, cfg))


def loss_and_grads(params, cfg, batch, microbatches: int = 1):
    """Mean loss and fp32 gradients of ``tfm.loss_fn``; with
    ``microbatches > 1`` the batch splits along its first axis and the
    gradients are summed over the pieces, then divided."""
    leaves, td = tree.flatten(params)

    def one(mb):
        ws = [x.detach().requires_grad_(True) for x in leaves]
        loss, _ = tfm.loss_fn(tree.unflatten(td, ws), cfg, mb)
        return loss.detach(), torch.autograd.grad(loss, ws)

    if microbatches == 1:
        loss, grads = one(batch)
        return loss, tree.unflatten(td, list(grads))
    gsum = [torch.zeros(x.shape, dtype=torch.float32, device=x.device) for x in leaves]
    lsum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for mb in zip(*(torch.chunk(v, microbatches) for v in batch.values())):
        loss, grads = one(dict(zip(batch, mb)))
        gsum = [s + g for s, g in zip(gsum, grads)]
        lsum = lsum + loss
    return lsum / microbatches, tree.unflatten(
        td, [(g / microbatches).to(torch.float32) for g in gsum])


def make_train_step(cfg, train_cfg: TrainConfig, optimizer=None):
    """``(train_step, optimizer)``; ``train_step(params, opt_state, batch)
    -> (params, opt_state, metrics)`` with the metrics ``loss``,
    ``grad_norm``, ``ortho_distance`` and ``health_finite`` as 0-d tensors
    on the card (reading them syncs)."""
    optimizer = optimizer or make_optimizer(cfg, train_cfg)
    # fp32 accumulation in every bf16 product, as JAX's
    # preferred_element_type: no reduced-precision split-K partial sums.
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, cfg, batch, train_cfg.microbatches)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optim.apply_updates(params, updates)
        health = core.step_health(opt_state)
        metrics = {
            "loss": loss,
            "grad_norm": optim.global_norm(grads),
            "ortho_distance": core.max_distance(opt_state),
            "health_finite": health.ok().to(torch.float32),
        }
        return params, opt_state, metrics

    return train_step, optimizer
