"""Batched serving engine: prefill + decode with continuous slot batching.

A port of `repro.serve.engine`. A fixed pool of `batch` slots; the queue is
served in waves of up to `batch` requests, every prompt left-padded to the
longest prompt of the whole queue (one common prefill length), then decoded
one token a step until the wave's longest request is done. Each request's
latency clock runs from its wave's start to its own last token. Greedy is
`argmax`; temperature sampling draws from a `torch.Generator` on the
device seeded with `seed` (its stream is not JAX's). An encoder-decoder
wave's batch carries zero `frames` (the audio stub), as the JAX engine's
does; the encoder's states ride in the cache, which decode reads and never
writes. Runs under `torch.inference_mode()`, on the card unless
`device="cpu"`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.api import Model, device_of
from repro_torch.models.common import torch_dtype


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (plen,) int32
    max_new_tokens: int = 16
    out_tokens: Optional[List[int]] = None
    latency_s: float = 0.0          # THIS request's admit -> last token


class ServeEngine:
    """Single-device engine. `stats` records, for each wave, the host
    seconds of its prefill (with the first token's sampling, which waits
    for the device) and of each decode step."""

    def __init__(self, model: Model, params, batch: int, max_len: int,
                 temperature: float = 0.0, seed: int = 0, device="cuda"):
        self.device = device_of(device)
        if model.device != self.device:
            raise ValueError(f"the model runs on {model.device}, the engine "
                             f"on {self.device}")
        self.model = model
        self.params = params
        self.batch = batch
        self.max_len = max_len
        self.temperature = temperature
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.stats: Dict[str, list] = {"prefill_s": [], "decode_s": []}

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        last = logits[:, -1]
        if self.temperature <= 0.0:
            return last.argmax(dim=-1).cpu().numpy()
        probs = torch.softmax(last.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.gen)[:, 0] \
            .cpu().numpy()

    def _tokens(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a.astype(np.int64)).to(self.device)

    def run(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Process all requests with continuous slot batching."""
        with torch.inference_mode():
            return self._run(requests)

    def _run(self, requests: List[Request]) -> Dict[int, List[int]]:
        queue = list(requests)
        for r in queue:
            r.out_tokens = []
        # pad all prompts to a common prefill length (slot-aligned)
        plen = max(len(r.prompt) for r in queue)
        results: Dict[int, List[int]] = {}

        while queue:
            active = queue[:self.batch]
            queue = queue[len(active):]
            t0 = time.perf_counter()
            toks = np.zeros((self.batch, plen), np.int32)
            for i, r in enumerate(active):
                toks[i, plen - len(r.prompt):] = r.prompt   # left-pad
            batch = {"tokens": self._tokens(toks)}
            cfg = self.model.cfg
            if cfg.encdec:
                batch["frames"] = torch.zeros(
                    (self.batch, cfg.encdec.encoder_len, cfg.d_model),
                    dtype=torch_dtype(cfg.dtype), device=self.device)
            logits, cache = self.model.prefill(self.params, batch,
                                               max_len=self.max_len)
            nxt = self._sample(logits)
            del logits
            self.stats["prefill_s"].append(time.perf_counter() - t0)

            def append(r, tok):
                """Record one token; a request's latency clock stops the
                moment ITS last token lands, not when the wave ends."""
                r.out_tokens.append(int(tok))
                if len(r.out_tokens) >= r.max_new_tokens:
                    r.latency_s = time.perf_counter() - t0

            for i, r in enumerate(active):
                append(r, nxt[i])
            pos = plen
            steps = max(r.max_new_tokens for r in active) - 1
            for _ in range(max(steps, 0)):
                t1 = time.perf_counter()
                tok = self._tokens(nxt[:, None])
                logits, cache = self.model.decode_step(self.params, cache,
                                                       tok, pos)
                nxt = self._sample(logits)
                self.stats["decode_s"].append(time.perf_counter() - t1)
                pos += 1
                for i, r in enumerate(active):
                    if len(r.out_tokens) < r.max_new_tokens:
                        append(r, nxt[i])
            for r in active:
                results[r.rid] = r.out_tokens
        return results
