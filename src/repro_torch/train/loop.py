"""The train step and the training loop, on one device.

A port of `repro.train.loop` for a single device: no mesh and no sharding
(`parallel/*` is not ported), so `make_train_step` is the JAX `step_fn`
without its sharding constraints — microbatch gradient accumulation
(`acc += g.to(grad_dtype) / microbatches`), then one AdamW update. A
batch is a dict of tensors (`tokens`, and an encoder-decoder's `frames`),
each split along its batch axis into microbatches. The step updates the
parameters and the optimizer state in place. `fit`
trains from a seed or resumes from the latest checkpoint in `ckpt_dir`
(`ckpt/checkpoint.py`), saving every `ckpt_every` steps and at the end.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Dict, Iterator, Optional

import torch

from repro_torch.models.api import Model
from repro_torch.models.common import torch_dtype
from repro_torch.train import optim as opt_lib


def make_train_step(model: Model, opt_cfg: opt_lib.OptConfig,
                    microbatches: int = 1, remat: str = "full",
                    grad_dtype: str = "float32"):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), metrics {"loss", "grad_norm", "lr"} as 0-dim tensors."""
    acc_dtype = torch_dtype(grad_dtype)

    def grads_of(params, batch):
        loss = model.loss(params, batch, remat=remat)
        return loss.detach(), torch.autograd.grad(
            loss, list(params.parameters()))

    def step_fn(params, opt_state, batch):
        params.requires_grad_(True)
        if microbatches > 1:
            split = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            grads = [torch.zeros(p.shape, dtype=acc_dtype, device=p.device)
                     for p in params.parameters()]
            losses = []
            for i in range(microbatches):
                loss, g = grads_of(params, {k: v[i] for k, v in
                                            split.items()})
                grads = [a + gi.to(acc_dtype) / microbatches
                         for a, gi in zip(grads, g)]
                losses.append(loss)
            loss = torch.stack(losses).mean()
        else:
            loss, grads = grads_of(params, batch)
        params, opt_state, metrics = opt_lib.apply_updates(
            opt_cfg, params, opt_state, grads)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step_fn


@dataclasses.dataclass
class WatchdogStats:
    """Straggler / slow-step detection: on real pods a slow step usually
    means a failing host or contended interconnect; we log and count so the
    launcher can decide to checkpoint-and-remesh."""
    times: list = dataclasses.field(default_factory=list)
    slow_steps: int = 0
    threshold: float = 3.0

    def record(self, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) >= 8:
            med = statistics.median(self.times[-64:])
            if dt > self.threshold * med:
                self.slow_steps += 1
                return True
        return False


def fit(model: Model, data_iter: Iterator[Dict[str, torch.Tensor]],
        steps: int, opt_cfg: Optional[opt_lib.OptConfig] = None,
        microbatches: int = 1, remat: str = "full",
        ckpt_dir: Optional[str] = None, ckpt_every: int = 100,
        log_every: int = 10, seed: int = 0,
        log_fn: Callable[[str], None] = print):
    """Train for `steps` from parameters drawn from `seed` on the model's
    device, or resume from the latest checkpoint in `ckpt_dir` (the data
    iterator, built at step 0, is fast-forwarded to the resumed step: a
    batch is a function of (seed, step)). With `ckpt_dir`, an
    `AsyncSaver` checkpoints every `ckpt_every` steps and at the end
    (parameters under `params/`, the optimizer state under `opt/`).
    Returns (params, opt_state, history), a history entry per step run
    with its host time (ending in a synchronise) and metrics."""
    from repro_torch.ckpt import checkpoint as ckpt_lib

    opt_cfg = opt_cfg or opt_lib.OptConfig(total_steps=steps)
    step_fn = make_train_step(model, opt_cfg, microbatches=microbatches,
                              remat=remat)
    params = model.init(torch.Generator(device=model.device)
                        .manual_seed(seed))
    opt_state = opt_lib.init_opt_state(params)
    start_step = 0
    if ckpt_dir:
        latest = ckpt_lib.latest_step(ckpt_dir)
        if latest is not None:
            log_fn(f"[fit] resuming from step {latest}")
            params, opt_state, start_step = ckpt_lib.restore(
                ckpt_dir, latest, params, opt_state)
            for _ in range(start_step):
                next(data_iter)
    watch = WatchdogStats()
    history = []
    saver = ckpt_lib.AsyncSaver(ckpt_dir) if ckpt_dir else None
    for step in range(start_step, steps):
        batch = next(data_iter)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.perf_counter() - t0
        if watch.record(dt):
            log_fn(f"[watchdog] slow step {step}: {dt:.3f}s "
                   f"(median {statistics.median(watch.times[-64:]):.3f}s)")
        history.append({"step": step, "time_s": dt, **metrics})
        if log_every and step % log_every == 0:
            log_fn(f"[fit] step {step} loss {metrics['loss']:.4f} "
                   f"gnorm {metrics['grad_norm']:.3f} {dt * 1e3:.0f}ms")
        if saver and ckpt_every and (step + 1) % ckpt_every == 0:
            saver.save(step + 1, params, opt_state)
    if saver:
        saver.save(steps, params, opt_state)
        saver.wait()
    return params, opt_state, history
