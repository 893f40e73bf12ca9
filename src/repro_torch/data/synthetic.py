"""Deterministic synthetic data pipeline.

A port of `repro.data.synthetic` (its numpy code copied). Batches are a
pure function of (seed, step), so a run replays the exact stream from any
step. A one-deep prefetch thread makes the next batch on the host while
the device computes; on CUDA it stages the batch in pinned host memory and
the copy to the card is asynchronous. An encoder-decoder config's batch
also carries `frames`, (B, encoder_len, d_model) float32 from the same
generator after the tokens, and the iterator copies them as it copies the
tokens.

With `mesh=` (a `DeviceMesh`) each rank yields its share of the global
batch as DTensors split over the data axes (`parallel/sharding.py::
data_spec`, the JAX iterator's `shardings=`): it makes the global batch
of (seed, step), as every rank does, and copies only its own rows.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def lm_batch(cfg: ModelConfig, seed: int, step: int, batch: int, seq: int,
             kind: str = "arith") -> Dict[str, np.ndarray]:
    """kind="arith": learnable modular arithmetic sequences (per-sequence
    random start/stride) so train-loss visibly decreases; "uniform": i.i.d.
    tokens (bandwidth/throughput benchmarks, nothing learnable)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    if kind == "uniform":
        tokens = rng.integers(0, cfg.vocab_size, size=(batch, seq),
                              dtype=np.int32)
    else:
        start = rng.integers(0, cfg.vocab_size, size=(batch, 1))
        stride = rng.integers(1, 9, size=(batch, 1))
        idx = np.arange(seq)[None, :]
        tokens = ((start + stride * idx) % cfg.vocab_size).astype(np.int32)
    out = {"tokens": tokens}
    if cfg.encdec:
        out["frames"] = rng.normal(
            0, 1, size=(batch, cfg.encdec.encoder_len, cfg.d_model)
        ).astype(np.float32)
    return out


def _rows(mesh, b: int, ndim: int):
    """This rank's rows of a global batch of `b` on `mesh`, and the
    DTensor placements of the batch (Shard(0) on its data axes; the same
    for any rank of tensor)."""
    from repro_torch.parallel import sharding as shd

    spec = shd.data_spec(mesh, b, ndim)
    axes = (spec[0],) if isinstance(spec[0], str) else spec[0] or ()
    r, n = shd.batch_rank(mesh, axes)
    return slice(r * (b // n), (r + 1) * (b // n)), shd.placements(spec,
                                                                   mesh)


def iterator(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
             start_step: int = 0, prefetch: int = 1, kind: str = "arith",
             device="cuda", mesh=None) -> Iterator[Dict[str, torch.Tensor]]:
    """Infinite deterministic iterator of batches on `device` (with
    `mesh`: this rank's shards on the mesh's device, as DTensors), with
    background prefetch (`prefetch` batches ahead; 0: none)."""
    if mesh is not None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if mesh.device_type == "cuda" else torch.device("cpu"))
    device = torch.device(device)
    pin = device.type == "cuda"

    # this rank's rows and the placements, read off the mesh once (the
    # prefetch thread touches no process group)
    rows, placed = _rows(mesh, batch, 2) if mesh is not None else (None, None)

    def host(step):
        b = {k: torch.from_numpy(v) for k, v in
             lm_batch(cfg, seed, step, batch, seq, kind=kind).items()}
        if mesh is not None:
            b = {k: v[rows].contiguous() for k, v in b.items()}
        return {k: v.pin_memory() for k, v in b.items()} if pin else b

    def to_device(b):
        out = {k: v.to(device, non_blocking=pin) for k, v in b.items()}
        if mesh is None:
            return out
        from torch.distributed.tensor import DTensor
        return {k: DTensor.from_local(
                    v, mesh, placed, shape=(batch,) + tuple(v.shape[1:]),
                    stride=torch.empty((batch,) + tuple(v.shape[1:]),
                                       device="meta").stride())
                for k, v in out.items()}

    if prefetch <= 0:
        step = start_step
        while True:
            yield to_device(host(step))
            step += 1

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            try:
                b = host(step)
            except Exception as e:  # noqa: BLE001 — raised by the consumer
                b = e
            while not stop.is_set():
                try:
                    q.put(b, timeout=0.1)
                    break
                except queue.Full:
                    pass
            step += 1

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            b = q.get()
            if isinstance(b, Exception):
                raise b
            yield to_device(b)
    finally:
        stop.set()
        t.join(timeout=10)   # no torch work left in the thread at exit
