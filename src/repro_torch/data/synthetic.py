"""Deterministic synthetic data pipeline.

A port of `repro.data.synthetic` (its numpy code copied). Batches are a
pure function of (seed, step), so a run replays the exact stream from any
step. A one-deep prefetch thread makes the next batch on the host while
the device computes; on CUDA it stages the batch in pinned host memory and
the copy to the card is asynchronous. An encoder-decoder config's batch
also carries `frames`, (B, encoder_len, d_model) float32 from the same
generator after the tokens, and the iterator copies them as it copies the
tokens.
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


def iterator(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
             start_step: int = 0, prefetch: int = 1, kind: str = "arith",
             device="cuda") -> Iterator[Dict[str, torch.Tensor]]:
    """Infinite deterministic iterator of batches on `device`, with
    background prefetch (`prefetch` batches ahead; 0: none)."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def host(step):
        b = {k: torch.from_numpy(v) for k, v in
             lm_batch(cfg, seed, step, batch, seq, kind=kind).items()}
        return {k: v.pin_memory() for k, v in b.items()} if pin else b

    def to_device(b):
        return {k: v.to(device, non_blocking=pin) for k, v in b.items()}

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
            b = host(step)
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
            yield to_device(q.get())
    finally:
        stop.set()
