"""Batched serving: prefill + decode steps, wave scheduler.

Iteration-level continuous batching ("waves"): requests queue up, are
grouped into fixed-size padded batches, prefilled together, and decoded
until every slot emits EOS or hits its token budget; finished slots keep
decoding but their tokens after EOS are cut, and the next wave refills
all slots.  The engine runs on one device, the card by default; prefill
attention there is the flash kernel (one launch per layer per wave) and
decode is a plain einsum over the cache.
"""
from __future__ import annotations

import dataclasses
import queue

import numpy as np
import torch

from repro_torch.models.model import resolve_device
from repro_torch.serving.sampling import sample


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # [S] int32
    max_new_tokens: int = 32


class ServeEngine:
    def __init__(self, mdl, params, *, batch_size: int, max_len: int,
                 eos_id: int = 2, temperature: float = 0.0, device="cuda"):
        self.device = resolve_device(device)
        if any(p.device != self.device for p in params.parameters()):
            raise ValueError(f"the model's parameters do not lie on {self.device}")
        self.mdl = mdl
        self.params = params
        self.b = batch_size
        self.max_len = max_len
        self.eos = eos_id
        self.temperature = temperature
        self.queue: "queue.Queue[Request]" = queue.Queue()

    def _prefill(self, tokens, caches):
        logits, caches = self.mdl.apply(self.params, {"tokens": tokens},
                                        mode="prefill", caches=caches)
        return logits[:, -1], caches

    def _decode(self, tokens, caches, generator):
        logits, caches = self.mdl.apply(self.params, {"tokens": tokens},
                                        mode="decode", caches=caches)
        return sample(logits[:, 0], generator, self.temperature), caches

    def submit(self, req: Request):
        self.queue.put(req)

    def _next_wave(self) -> list[Request]:
        """Length-bucketed admission: a wave shares one prompt length, so
        no padding tokens ever enter attention (masks stay exact)."""
        wave: list[Request] = []
        deferred: list[Request] = []
        while len(wave) < self.b and not self.queue.empty():
            r = self.queue.get()
            if not wave or len(r.prompt) == len(wave[0].prompt):
                wave.append(r)
            else:
                deferred.append(r)
        for r in deferred:
            self.queue.put(r)
        return wave

    def run(self, generator: torch.Generator | None = None) -> dict[int, np.ndarray]:
        """Drain the queue; returns rid -> generated tokens.  ``generator``
        (on the engine's device) draws the samples when temperature > 0."""
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        results: dict[int, np.ndarray] = {}
        while not self.queue.empty():
            wave = self._next_wave()
            plen = len(wave[0].prompt)
            tokens = np.zeros((self.b, plen), np.int32)
            for i, r in enumerate(wave):
                tokens[i] = r.prompt
            budget = max(r.max_new_tokens for r in wave)

            caches = self.mdl.init_caches(self.b, self.max_len, device=self.device)
            last, caches = self._prefill(
                torch.from_numpy(tokens).to(self.device), caches)
            nxt = sample(last, generator, self.temperature)
            out = [nxt]
            done = np.zeros(self.b, bool)
            for _ in range(budget - 1):
                nxt, caches = self._decode(nxt[:, None], caches, generator)
                out.append(nxt)
                done |= nxt.cpu().numpy() == self.eos
                if done[: len(wave)].all():
                    break
            gen = torch.stack(out, 1).cpu().numpy()  # [B, T]
            for i, r in enumerate(wave):
                toks = gen[i]
                stop = np.nonzero(toks == self.eos)[0]
                if len(stop):
                    toks = toks[: stop[0] + 1]
                results[r.rid] = toks[: r.max_new_tokens]
        return results
