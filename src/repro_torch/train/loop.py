"""The train step and the training loop, on one device or a device mesh.

A port of `repro.train.loop`. `make_train_step` is the JAX `step_fn`:
microbatch gradient accumulation (`acc += g.to(grad_dtype) /
microbatches`), then one AdamW update. A batch is a dict of tensors
(`tokens`, and an encoder-decoder's `frames`), each split along its batch
axis into microbatches. The step updates the parameters and the
optimizer state in place. `fit` trains from a seed or resumes from the
latest checkpoint in `ckpt_dir` (`ckpt/checkpoint.py`), saving every
`ckpt_every` steps and at the end.

With `mesh=` (a `torch.distributed` `DeviceMesh` with "data" and "model"
axes, `launch/mesh.py::make_device_mesh`; one process a device) the
parameters become DTensors placed by the rule table
(`parallel/sharding.py`, kind "train": FSDP over "data", TP/EP over
"model"), the optimizer state takes their placements, the batch is split
over the data axes (a microbatch is the JAX reshape's: rows
[i·B/mb, (i+1)·B/mb) of the global batch, sharded over the data axes), and
every gradient is pinned to its parameter's placements (the gathers'
backward reduce-scatters it; `_pin_grads`) before the update. Every rank
runs the same step; `fit` logs on rank 0 only.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Dict, Iterator, Optional

import torch

from repro_torch.models.api import Model
from repro_torch.models.common import torch_dtype
from repro_torch.parallel import policy
from repro_torch.parallel import sharding as shd
from repro_torch.train import optim as opt_lib


def distribute_state(opt_state, params, mesh):
    """An optimizer state of full tensors as DTensors in its parameters'
    placements (`step` replicated); one already distributed as it is."""
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    if shd.is_distributed(opt_state["step"]):
        return opt_state
    placed = dict(params.named_parameters())
    out = {k: {n: distribute_tensor(t, mesh, placed[n].placements)
               for n, t in opt_state[k].items()}
           for k in ("m", "v", "master")}
    step = opt_state["step"].to(placed[next(iter(placed))].to_local().device)
    out["step"] = DTensor.from_local(step, mesh, [Replicate()] * mesh.ndim)
    return out


def shard_batch(batch, mesh):
    """A batch of full tensors (the same on every rank) as DTensors split
    over the data axes (`sharding.data_spec`); DTensors as they are."""
    from torch.distributed.tensor import distribute_tensor

    return {k: v if shd.is_distributed(v) else distribute_tensor(
                v, mesh, shd.placements(
                    shd.data_spec(mesh, v.shape[0], v.dim()), mesh))
            for k, v in batch.items()}


def _microbatches(batch, mesh, n):
    """The JAX reshape's microbatches of a DTensor batch: rows
    [i·B/n, (i+1)·B/n) of the global batch, each split over the data
    axes."""
    full = {k: v.full_tensor() for k, v in batch.items()}
    rows = next(iter(full.values())).shape[0] // n
    return [shard_batch({k: v[i * rows:(i + 1) * rows].contiguous()
                         for k, v in full.items()}, mesh)
            for i in range(n)]


def _pin_grads(grads, params):
    """Each gradient in its parameter's placements (a `Partial` sum is
    reduced, a copy sliced to the shard)."""
    return [g if g.placements == p.placements
            else g.redistribute(p.device_mesh, p.placements)
            for g, p in zip(grads, params.parameters())]


def make_train_step(model: Model, opt_cfg: opt_lib.OptConfig,
                    microbatches: int = 1, remat: str = "full",
                    grad_dtype: str = "float32", *, mesh=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), metrics {"loss", "grad_norm", "lr"} as 0-dim tensors.

    With `mesh`, returns (train_step, (p_spec, o_spec)): the parameters'
    specs by name (`sharding.params_sharding(..., "train")`) and the
    optimizer state's (`m`, `v`, `master` those, `step` replicated), as
    the JAX package returns its shardings. Its train_step distributes
    full parameters, optimizer state and batch on first sight, and takes
    them distributed; it runs sequence-parallel where the rules its
    caller set say `seq_shard` (`parallel/policy.py`), as the JAX
    package's step does under its caller's rules."""
    acc_dtype = torch_dtype(grad_dtype)

    def grads_of(params, batch):
        loss = model.loss(params, batch, remat=remat)
        grads = torch.autograd.grad(loss, list(params.parameters()))
        if mesh is not None:
            grads = _pin_grads(grads, params)
        return loss.detach(), grads

    def accumulate(params, batches):
        if len(batches) == 1:
            return grads_of(params, batches[0])
        grads = [torch.zeros_like(p, dtype=acc_dtype)
                 for p in params.parameters()]
        losses = []
        for mb in batches:
            loss, g = grads_of(params, mb)
            grads = [a + gi.to(acc_dtype) / microbatches
                     for a, gi in zip(grads, g)]
            losses.append(loss)
        return torch.stack(losses).mean(), grads

    def step_fn(params, opt_state, batch):
        params.requires_grad_(True)
        if microbatches > 1:
            split = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            batches = [{k: v[i] for k, v in split.items()}
                       for i in range(microbatches)]
        else:
            batches = [batch]
        loss, grads = accumulate(params, batches)
        params, opt_state, metrics = opt_lib.apply_updates(
            opt_cfg, params, opt_state, grads)
        metrics["loss"] = loss
        return params, opt_state, metrics

    if mesh is None:
        return step_fn

    p_spec = shd.params_sharding(model.param_shapes(), mesh, "train")
    o_spec = {"m": p_spec, "v": p_spec, "master": p_spec, "step": shd.P()}

    def mesh_step(params, opt_state, batch):
        params = shd.distribute(params, mesh, "train", p_spec)
        opt_state = distribute_state(opt_state, params, mesh)
        batch = shard_batch(batch, mesh)
        batches = (_microbatches(batch, mesh, microbatches)
                   if microbatches > 1 else [batch])
        params.requires_grad_(True)
        rows = next(iter(batches[0].values())).shape[0]
        caller = policy.current()       # keeps the caller's seq_shard
        with policy.activation_rules(
                shd.batch_sharding(mesh, rows), mesh,
                seq_shard=bool(caller and caller["seq_shard"])):
            loss, grads = accumulate(params, batches)
        params, opt_state, metrics = opt_lib.apply_updates(
            opt_cfg, params, opt_state, grads)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return mesh_step, (p_spec, o_spec)


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
        log_fn: Callable[[str], None] = print, *, mesh=None):
    """Train for `steps` from parameters drawn from `seed` on the model's
    device, or resume from the latest checkpoint in `ckpt_dir` (the data
    iterator, built at step 0, is fast-forwarded to the resumed step: a
    batch is a function of (seed, step)). With `ckpt_dir`, an
    `AsyncSaver` checkpoints every `ckpt_every` steps and at the end
    (parameters under `params/`, the optimizer state under `opt/`).
    Returns (params, opt_state, history), a history entry per step run
    with its host time (ending in a synchronise) and metrics.

    With `mesh` (a `DeviceMesh`; every rank calls `fit` alike) every rank
    draws the same parameters from `seed` and keeps its shards, a resumed
    checkpoint is placed by the current mesh's rule table (written on any
    mesh or one device), checkpoints are gathered on every rank and
    written by rank 0, and only rank 0 logs."""
    from repro_torch.ckpt import checkpoint as ckpt_lib

    opt_cfg = opt_cfg or opt_lib.OptConfig(total_steps=steps)
    step_fn = make_train_step(model, opt_cfg, microbatches=microbatches,
                              remat=remat, mesh=mesh)
    if mesh is not None:
        step_fn, (p_spec, _) = step_fn
        log = log_fn
        log_fn = lambda msg: shd.is_rank0() and log(msg)     # noqa: E731
    params = model.init(torch.Generator(device=model.device)
                        .manual_seed(seed))
    if mesh is not None:
        params = shd.distribute(params, mesh, "train", p_spec)
    opt_state = opt_lib.init_opt_state(params)
    start_step = 0
    if ckpt_dir:
        latest = ckpt_lib.latest_step(ckpt_dir)
        if latest is not None:
            log_fn(f"[fit] resuming from step {latest}")
            params, opt_state, start_step = ckpt_lib.restore(
                ckpt_dir, latest, params, opt_state, mesh=mesh)
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
