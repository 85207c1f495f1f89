"""Continuous batching scheduler for serving (counterpart of
gemma_tpu/engine/serving.py).

The reference serves with a static decode_qbatch (gemma/gemma.cc:588-606):
a wave of queries runs to completion before the next starts, so one long
reply stalls the whole wave.  This scheduler keeps a fixed number of
decode slots hot and admits queued requests into slots as they free up:

  - fixed shapes: every tick's decode step runs all `slots` rows, one
    launch of each kernel for the whole batch; slots without a decoding
    request ride it with valid=False, which sends their KV row writes
    to the cache's garbage row;
  - chunk-limited admission: each tick prefills at most `admission_chunk`
    prompt tokens of every admitting slot, in one batched prefill at
    per-slot start positions, before the decode step, so a long prompt
    never stalls in-flight decodes for more than one chunk;
  - per-slot ring KV caches inside one batched cache;
  - streaming callbacks + EOS / max-token / callback retirement per slot;
  - session continuation: a request carrying a batch-1 KVCache and its
    start_pos is admitted by COPYING its rows into a slot (no
    re-prefill), shares decode steps with everything else, and gets the
    slot's rows back at retirement, with `end_pos` set.

The logits come to the host every tick, where the pick runs
(`GemmaEngine._sample`), as in the JAX package.

Usage:
    batcher = ContinuousBatcher(engine, slots=16)
    batcher.submit(Request(prompt_ids, max_tokens=128, on_token=cb))
    batcher.run_until_idle()
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Callable, Sequence

import numpy as np
import torch

from gemma_tpu_torch.engine.engine import GemmaEngine
from gemma_tpu_torch.models.kv_cache import (KVCache, check_session_layout,
                                             extract_slot, insert_slot,
                                             new_like)

_ids = itertools.count()


@dataclasses.dataclass
class Request:
    prompt_ids: Sequence[int]
    max_tokens: int = 256
    on_token: Callable[["Request", int], bool] | None = None
    request_id: int = dataclasses.field(default_factory=lambda: next(_ids))
    output: list = dataclasses.field(default_factory=list)
    done: bool = False
    # Session continuation: a batch-1 KVCache whose rows already hold
    # positions [0, start_pos).  The slot adopts it (one copy of its rows,
    # no re-prefill) and prompt_ids carry only the new turn's tokens.  At
    # retirement the slot's rows are handed back into `cache`
    # (KVCache.assign) and end_pos is the next unwritten position.
    cache: KVCache | None = None
    start_pos: int = 0
    end_pos: int = 0


@dataclasses.dataclass
class _Slot:
    request: Request | None = None
    pos: int = 0            # next decode position (last prompt token first)
    prev_token: int = 0
    remaining: int = 0
    # Prompt tokens written to KV so far (admission in progress); the slot
    # joins decode once all but the final token are written.
    filled: int = 0
    base: int = 0           # absolute position of prompt_ids[0]

    @property
    def admitting(self) -> bool:
        return (self.request is not None
                and self.filled < len(self.request.prompt_ids) - 1)


class ContinuousBatcher:
    def __init__(self, engine: GemmaEngine, slots: int | None = None,
                 seq_len: int | None = None,
                 admission_chunk: int | None = None):
        self.engine = engine
        self.slots = slots or engine.runtime.decode_qbatch_size
        self.seq_len = seq_len or engine.runtime.seq_len
        self.admission_chunk = (admission_chunk
                                or engine.prefill_chunk(
                                    engine.runtime.decode_qbatch_size))
        self.cache = engine.new_cache(self.slots, self.seq_len)
        self._slots = [_Slot() for _ in range(self.slots)]
        self._queue: deque[Request] = deque()

    # --- public API ---

    def submit(self, request: Request) -> Request:
        if request.cache is not None:
            check_session_layout(self.cache, request.cache)
        if not request.prompt_ids:
            raise ValueError("prompts must be non-empty")
        self._queue.append(request)
        return request

    def session_cache(self) -> KVCache:
        """A zeroed batch-1 cache with this batcher's per-slot layout, for a
        session to carry from turn to turn.  engine.new_cache(1) sizes the
        local rings' slack for batch-1 prefill chunks (1024 rows), the
        batcher's cache for its slots' (512), so on a model with local
        layers its layout differs and submit would refuse it."""
        return new_like(self.cache, 1)

    @property
    def active(self) -> int:
        """Slots holding a request (admitting or decoding)."""
        return sum(1 for s in self._slots if s.request is not None)

    @property
    def decoding(self) -> int:
        """Slots whose prompt is fully prefilled (take decode steps)."""
        return sum(1 for s in self._slots
                   if s.request is not None and not s.admitting)

    @property
    def pending(self) -> int:
        return len(self._queue)

    def run_until_idle(self) -> None:
        while self.pending or self.active:
            self.step()

    # --- scheduling ---

    def _admit(self) -> None:
        """Assign queued requests to free slots; prefill happens in
        chunk-limited rounds via _advance_admissions.  Session requests
        (req.cache) first adopt their history rows into the slot."""
        for i, slot in enumerate(self._slots):
            if slot.request is None and self._queue:
                req = self._queue.popleft()
                slot.request = req
                slot.filled = 0
                slot.base = req.start_pos
                slot.pos = req.start_pos + len(req.prompt_ids) - 1
                slot.prev_token = int(req.prompt_ids[-1])
                slot.remaining = req.max_tokens
                if req.cache is not None:
                    insert_slot(self.cache, req.cache, i)

    def _advance_admissions(self) -> None:
        """Prefill at most `admission_chunk` tokens of every admitting slot
        in ONE batched pass (per-slot valid masks confine KV writes), so
        in-flight decodes stall for one chunk at most."""
        if not any(s.admitting for s in self._slots):
            return
        c = self.admission_chunk
        # One-token dummy prompts for the other slots (prefill writes
        # nothing of them); each admitting slot advances by <= c tokens.
        # The chunk carries one lookahead token so prefill (which writes
        # all but the last token) writes exactly the chunk; the final
        # prompt token is never written here: it is the slot's first
        # decode input, as in Gemma::Generate.
        prompts = [[0] for _ in range(self.slots)]
        start_pos = [0] * self.slots
        for i, slot in enumerate(self._slots):
            if not slot.admitting:
                continue
            ids = slot.request.prompt_ids
            lo = slot.filled
            hi = min(lo + c, len(ids) - 1)
            prompts[i] = list(ids[lo:hi + 1])
            start_pos[i] = slot.base + lo
            slot.filled = hi
        self.engine.prefill(prompts, self.cache, start_pos=start_pos)

    def step(self) -> None:
        """One scheduler tick: admit, one admission chunk, one decode step
        for every slot that has finished prefilling."""
        self._admit()
        self._advance_admissions()
        self._decode_tick()

    def _decode_tick(self) -> None:
        """One decode step of all slots; the decoding ones take a token."""
        if self.decoding == 0:
            return
        dev = self.engine.device
        prev = torch.tensor([[s.prev_token] for s in self._slots],
                            dtype=torch.int32, device=dev)
        pos = [s.pos for s in self._slots]
        # Padding slots (empty or still admitting) must not write a real
        # ring row: a row at their stale pos could alias a still-attended
        # position of a prompt being admitted into the same ring (local
        # rings wrap).  valid=False routes their write to the garbage row.
        valid = torch.tensor([[s.request is not None and not s.admitting]
                              for s in self._slots], device=dev)
        logits, _ = self.engine.decode_step(
            prev, torch.tensor(np.asarray(pos, np.int32)[:, None],
                               device=dev), self.cache, valid)
        tokens, _ = self.engine._sample(logits, pos, None)
        config = self.engine.config
        for i, slot in enumerate(self._slots):
            req = slot.request
            if req is None or slot.admitting:
                continue  # padding: its logits are ignored
            tok = int(tokens[i])
            keep = True
            if req.on_token is not None:
                keep = req.on_token(req, tok)
            req.output.append(tok)
            slot.prev_token = tok
            slot.pos += 1
            slot.remaining -= 1
            if config.is_eos(tok) or slot.remaining <= 0 or not keep:
                if req.cache is not None:
                    # Hand the slot's rows back BEFORE signalling done
                    # (waiters read the cache).
                    req.cache.assign(extract_slot(self.cache, i))
                    req.end_pos = slot.pos + 1
                req.done = True
                slot.request = None
