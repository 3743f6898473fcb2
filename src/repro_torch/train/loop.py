"""Fault-tolerant training loop (``repro.train.loop``).

* auto-resume: on start, restore the newest valid checkpoint (params,
  optimizer state, data step) and continue; the data pipeline is a pure
  function of the step, so the token stream replays exactly;
* preemption: SIGTERM/SIGINT set a flag; the loop checkpoints and exits
  at the next step boundary;
* crash checkpoint: an exception triggers a best-effort save, then
  re-raises;
* straggler log: a step slower than ``straggler_factor`` times the
  rolling median is logged;
* async checkpoints every ``save_every`` steps (keep-last-k);
* divergence rollback (``LoopConfig.rollback``): a non-finite loss or
  ``health_finite == 0`` restores the newest valid checkpoint, marks the
  step's batch as poisoned (consumed and skipped on the replay) and
  resumes.

Reading the loss each step (the straggler clock) is one host sync per
step; the rollback verdict reads ``health_finite`` as well. The seeded
chaos plans of ``repro.faults`` are not ported: ``fault_plan`` raises.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import signal
import time
from collections import deque
from typing import Any, Callable, Optional

import numpy as np
import torch

from .. import tree
from ..checkpoint import checkpoint as ckpt

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    save_every: int = 50
    keep_last: int = 3
    checkpoint_dir: Optional[str] = None
    log_every: int = 10
    straggler_factor: float = 3.0  # step > factor * rolling median => flag
    async_save: bool = True
    rollback: bool = False
    max_rollbacks: int = 8


class _PreemptionGuard:
    def __init__(self):
        self.requested = False
        self._old = {}

    def __enter__(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._old[sig] = signal.signal(sig, self._handler)
            except ValueError:  # not the main thread
                pass
        return self

    def _handler(self, signum, frame):
        log.warning("preemption signal %s received; checkpointing at next step", signum)
        self.requested = True

    def __exit__(self, *exc):
        for sig, old in self._old.items():
            signal.signal(sig, old)
        return False


def drift(params, scale: float, select: Optional[Callable[[str], bool]] = None):
    """``params`` with every floating matrix leaf (ndim >= 2) whose path
    ``select`` accepts (all of them by default) scaled by ``1 + scale``:
    weights pushed off their manifold, as the JAX package's drift
    injection does."""
    out = []
    for path, x in tree.flatten_with_path(params):
        hit = (isinstance(x, torch.Tensor) and x.is_floating_point() and x.dim() >= 2
               and (select is None or select("/".join(str(p) for p in path))))
        out.append(x * (1.0 + scale) if hit else x)
    return tree.unflatten(tree.flatten(params)[1], out)


def _diverged(metrics) -> bool:
    """A failed StepHealth verdict or a non-finite loss."""
    health = metrics.get("health_finite")
    if health is not None and float(health) == 0.0:
        return True
    return not math.isfinite(float(metrics["loss"]))


def train(train_step: Callable, params: Any, opt_state: Any, data_iter,
          loop_cfg: LoopConfig, *, on_metrics=None, fault_plan=None):
    """Returns ``(params, opt_state, step, history)``; resumes on its own."""
    if fault_plan is not None:
        raise NotImplementedError(
            "fault plans are not ported yet (ROADMAP: self-healing training (faults.py))")
    if loop_cfg.rollback and not loop_cfg.checkpoint_dir:
        raise ValueError("LoopConfig.rollback requires a checkpoint_dir")

    def save_sync(at_step, state):
        return ckpt.save(loop_cfg.checkpoint_dir, at_step, state,
                         keep_last=loop_cfg.keep_last)

    start_step = 0
    if loop_cfg.checkpoint_dir:
        step_found, restored = ckpt.restore_latest(loop_cfg.checkpoint_dir,
                                                   (params, opt_state))
        if step_found is not None:
            params, opt_state = restored
            start_step = step_found
            data_iter.step = start_step
            log.info("resumed from checkpoint at step %d", start_step)
        elif loop_cfg.rollback:
            save_sync(0, (params, opt_state))  # a restore target for step 0

    history = []
    times: deque = deque(maxlen=50)
    pending_save = None
    poisoned: set = set()
    rollbacks = 0
    with _PreemptionGuard() as guard:
        step = start_step
        try:
            while step < loop_cfg.total_steps:
                if step in poisoned:
                    next(data_iter)  # consume and drop the poison batch
                    log.warning("skipping poisoned batch at step %d", step)
                    step += 1
                    continue
                t0 = time.monotonic()
                batch = next(data_iter)
                params, opt_state, metrics = train_step(params, opt_state, batch)
                float(metrics["loss"])  # the step's end: the straggler clock
                dt = time.monotonic() - t0
                if loop_cfg.rollback and _diverged(metrics):
                    rollbacks += 1
                    if rollbacks > loop_cfg.max_rollbacks:
                        raise RuntimeError(
                            f"divergence at step {step}: rollback budget "
                            f"({loop_cfg.max_rollbacks}) exhausted")
                    if pending_save is not None:
                        pending_save.join()
                        pending_save = None
                    back_step, restored = ckpt.restore_latest(
                        loop_cfg.checkpoint_dir, (params, opt_state))
                    if back_step is None:
                        raise RuntimeError(
                            f"divergence at step {step} but no valid checkpoint "
                            f"to roll back to in {loop_cfg.checkpoint_dir!r}")
                    params, opt_state = restored
                    poisoned.add(step)
                    log.warning(
                        "divergence at step %d: rolled back to step %d (rollback "
                        "%d/%d); the poisoned batch will be skipped on replay",
                        step, back_step, rollbacks, loop_cfg.max_rollbacks)
                    step = back_step
                    data_iter.step = back_step
                    times.clear()
                    continue
                times.append(dt)
                med = float(np.median(times))
                if len(times) >= 10 and dt > loop_cfg.straggler_factor * med:
                    log.warning("straggler: step %d took %.3fs (median %.3fs)",
                                step, dt, med)
                step += 1
                if step % loop_cfg.log_every == 0 or step == loop_cfg.total_steps:
                    snap = {k: float(v) for k, v in metrics.items()}
                    snap["step_time_s"] = dt
                    history.append((step, snap))
                    if on_metrics:
                        on_metrics(step, snap)
                    log.info("step %d %s", step, snap)
                want_save = loop_cfg.checkpoint_dir and (
                    step % loop_cfg.save_every == 0 or guard.requested)
                if want_save:
                    if pending_save is not None:
                        pending_save.join()
                    if loop_cfg.async_save and not guard.requested:
                        pending_save = ckpt.save_async(
                            loop_cfg.checkpoint_dir, step, (params, opt_state),
                            keep_last=loop_cfg.keep_last)
                    else:
                        save_sync(step, (params, opt_state))
                if guard.requested:
                    log.warning("exiting cleanly after preemption at step %d", step)
                    break
            # a finished run is always resumable
            if loop_cfg.checkpoint_dir and step > start_step and not guard.requested:
                if pending_save is not None:
                    pending_save.join()
                    pending_save = None
                save_sync(step, (params, opt_state))
        except Exception:
            if loop_cfg.checkpoint_dir:
                try:
                    save_sync(step, (params, opt_state))
                    log.warning("crash checkpoint written at step %d", step)
                except Exception:  # noqa: BLE001
                    log.exception("crash checkpoint failed")
            raise
        finally:
            if pending_save is not None:
                pending_save.join()
    return params, opt_state, step, history
