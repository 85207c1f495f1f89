"""Generation engine (counterpart of gemma_tpu/engine/engine.py; reference
gemma/gemma.{h,cc} GenerateT).

`GemmaEngine.generate_batch` prefills every prompt in token chunks
(ragged prompts share rounds, padded slots write the garbage row), then
decodes greedily one step per token with per-token `stream_token`
callbacks and EOS tracking.  Each decode step is `forward(...,
return_logits="last")` followed by the greedy pick on the host side of
the logits, the reference's per-token streaming (engine.py:60-65).

This slice serves greedy decode with `decode_chunk=1` over an i8 KV
cache; multi-step decode chunks and the fused greedy head
(`decode_chunk>1`, the TPU's _top1_kernel), top-k sampling and
`accept_token` constraints are later slices and raise here.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from gemma_tpu_torch.engine.timing import TimingInfo
from gemma_tpu_torch.models.configs import ModelConfig
from gemma_tpu_torch.models.gemma import Params, forward
from gemma_tpu_torch.models.kv_cache import LOCAL_RING_SLACK, KVCache
from gemma_tpu_torch.ops import sampling
from gemma_tpu_torch.utils.basics import resolve_device

StreamFunc = Callable[[int, int, int, float], bool]


@dataclasses.dataclass
class RuntimeConfig:
    """Maps InferenceArgs/RuntimeConfig (gemma/gemma_args.h:114-265).

    The defaults are the configuration this slice serves: greedy
    (top_k=1), one decode step per dispatch, i8 KV cache."""

    max_generated_tokens: int = 2048
    # 0 = auto: 1024 at batch 1, 512 at batch >= 2, capped to the next
    # power of two >= the prompt length (engine.py:332-347).
    prefill_tbatch_size: int = 0
    top_k: int = 1
    seq_len: int = 8192
    decode_chunk: int = 1
    kv_kind: str = "i8"


class GemmaEngine:
    """Owns params and runs prefill + decode on one device.

    device=None means CUDA, and raises when CUDA is unavailable; the
    tests pass device="cpu" to run the plain PyTorch path."""

    def __init__(self, params: Params, config: ModelConfig,
                 runtime: RuntimeConfig | None = None, device=None):
        self.device = resolve_device(device)
        self.config = config
        self.runtime = runtime or RuntimeConfig()
        rt = self.runtime
        if rt.decode_chunk != 1:
            raise NotImplementedError(
                "decode_chunk > 1 needs the fused greedy head (the TPU's "
                "_top1_kernel, K3), the next slice of the port")
        if rt.top_k != 1:
            raise NotImplementedError(
                "top_k > 1 sampling needs the fused top-k head (K6), a "
                "later slice of the port")
        if rt.kv_kind != "i8":
            raise NotImplementedError(
                f"kv_kind={rt.kv_kind!r}: this slice's attention kernels "
                "serve the i8 KV cache; bf16/f32 pools are a later slice")
        if params.device.type != self.device.type:
            raise ValueError(f"params live on {params.device}, the engine "
                             f"runs on {self.device}")
        self.params = params

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prefill_chunk(self, batch: int, max_len: int | None = None) -> int:
        """The prefill chunk for a `batch`-query call (engine.py:332-347)."""
        chunk = self.runtime.prefill_tbatch_size
        if chunk <= 0:
            chunk = 1024 if batch == 1 else 512
            if max_len is not None and max_len < chunk:
                chunk = max(64, 1 << (max_len - 1).bit_length())
        return chunk

    def new_cache(self, batch: int, seq_len: int | None = None,
                  min_local_slack: int = 0) -> KVCache:
        """A cache whose local rings have slack >= the largest chunk."""
        slack = max(LOCAL_RING_SLACK, self.prefill_chunk(batch),
                    min_local_slack)
        return KVCache.create(self.config, batch,
                              seq_len or self.runtime.seq_len,
                              kind=self.runtime.kv_kind, local_slack=slack,
                              device=self.device)

    def prefill(self, prompts: Sequence[Sequence[int]], cache: KVCache,
                start_pos: Sequence[int] | None = None,
                prefix_end: Sequence[int] | None = None,
                stream_token: StreamFunc | None = None
                ) -> tuple[KVCache, list[int]]:
        """Prefill all but the last prompt token; returns (cache, last tokens).

        Round j prefills tokens [j*C, (j+1)*C) of every query at once with
        per-slot valid masks (gemma.cc:188-283, engine.py:377-491)."""
        batch = len(prompts)
        start_pos = list(start_pos or [0] * batch)
        prefix_end = list(prefix_end or [0] * batch)
        chunk = self.prefill_chunk(batch, max(len(p) for p in prompts))
        if self.runtime.prefill_tbatch_size <= 0 and cache.kv_local is not None:
            chunk = min(chunk, cache.local_slack)
        if any(pe > 0 for pe in prefix_end):
            chunk = max(chunk, max(prefix_end))
        if cache.kv_local is not None and chunk > cache.local_slack:
            raise ValueError(
                f"prefill chunk {chunk} exceeds the local KV ring slack "
                f"{cache.local_slack}; create the cache with local_slack >= "
                "the chunk size")
        prompts = [list(p) for p in prompts]
        for p in prompts:
            if not p:
                raise ValueError("prompts must be non-empty")
        last_tokens = [int(p[-1]) for p in prompts]
        n_prefill = []
        for qi, prompt in enumerate(prompts):
            n = len(prompt) - 1
            if n < prefix_end[qi]:
                n += 1  # the last token is inside the prefix (gemma.cc:219-232)
            n_prefill.append(n)

        pe = torch.tensor(prefix_end, dtype=torch.int32, device=self.device)
        rounds = (max(n_prefill) + chunk - 1) // chunk
        for j in range(rounds):
            lo = j * chunk
            tokens = np.zeros((batch, chunk), np.int32)
            positions = np.zeros((batch, chunk), np.int32)
            valid = np.zeros((batch, chunk), bool)
            for qi, prompt in enumerate(prompts):
                n = min(chunk, n_prefill[qi] - lo)
                if n <= 0:
                    continue
                tokens[qi, :n] = prompt[lo:lo + n]
                positions[qi] = np.arange(start_pos[qi] + lo,
                                          start_pos[qi] + lo + chunk)
                valid[qi, :n] = True
            forward(self.params, torch.from_numpy(tokens).to(self.device),
                    torch.from_numpy(positions).to(self.device), cache,
                    self.config, prefix_end=pe, return_logits="none",
                    valid=torch.from_numpy(valid).to(self.device))
            if stream_token is not None:
                for qi, prompt in enumerate(prompts):
                    n = min(chunk, n_prefill[qi] - lo)
                    for i in range(max(n, 0)):
                        if lo + i < len(prompt) - 1:
                            stream_token(qi, start_pos[qi] + lo + i,
                                         int(tokens[qi, i]), 0.0)
        return cache, last_tokens

    def generate(self, prompt: Sequence[int], **kw) -> list[int]:
        """Single-query generation (Gemma::Generate, gemma.cc:663-674)."""
        start_pos = kw.pop("start_pos", 0)
        prefix_end = kw.pop("prefix_end", 0)
        return self.generate_batch([prompt], start_pos=[start_pos],
                                   prefix_end=[prefix_end], **kw)[0]

    def generate_batch(self, prompts: Sequence[Sequence[int]],
                       max_generated_tokens: int | None = None,
                       stream_token: StreamFunc | None = None,
                       accept_token=None, cache: KVCache | None = None,
                       start_pos: Sequence[int] | None = None,
                       prefix_end: Sequence[int] | None = None,
                       timing_info: TimingInfo | None = None
                       ) -> list[list[int]]:
        """Batched generation with EOS tracking (GenerateT, gemma.cc:488-568)."""
        if accept_token is not None:
            raise NotImplementedError(
                "accept_token constraints need candidate-restricted "
                "sampling, a later slice of the port")
        rt = self.runtime
        batch = len(prompts)
        max_gen = max_generated_tokens or rt.max_generated_tokens
        timing = timing_info or TimingInfo()
        start_pos = list(start_pos or [0] * batch)
        prefix_end = list(prefix_end or [0] * batch)
        if cache is None:
            cache = self.new_cache(batch, min_local_slack=max(prefix_end))
        self._sync()
        timing.prefill_start = time.monotonic()
        try:
            return self._generate_loop(prompts, cache, start_pos, prefix_end,
                                       stream_token, max_gen, timing)
        finally:
            timing.notify_generate_done()

    def _generate_loop(self, prompts, cache, start_pos, prefix_end,
                       stream_token, max_gen, timing):
        batch = len(prompts)
        cache, last_tokens = self.prefill(prompts, cache, start_pos,
                                          prefix_end, stream_token)
        self._sync()
        timing.notify_prefill(sum(len(p) - 1 for p in prompts))

        non_eos = [True] * batch
        pos = [start_pos[qi] + len(prompts[qi]) - 1 for qi in range(batch)]
        for qi in range(batch):
            if stream_token is not None and not stream_token(
                    qi, pos[qi], last_tokens[qi], 0.0):
                non_eos[qi] = False

        outputs: list[list[int]] = [[] for _ in range(batch)]
        prev = np.asarray(last_tokens, np.int32)
        timing.generate_start = time.monotonic()
        done = 0
        while done < max_gen and any(non_eos):
            t_step = time.monotonic()
            positions = np.asarray(pos, np.int32)
            logits, cache = forward(
                self.params, torch.from_numpy(prev[:, None]).to(self.device),
                torch.from_numpy(positions[:, None]).to(self.device), cache,
                self.config, return_logits="last")
            tokens, probs = sampling.top1(logits)
            tokens, probs = tokens.cpu().numpy(), probs.cpu().numpy()
            timing.decode_steps += 1
            timing.decode_step_seconds.append(time.monotonic() - t_step)
            timing.notify_generated(sum(non_eos))
            for qi in range(batch):
                if not non_eos[qi]:
                    continue
                tok, prob = int(tokens[qi]), float(probs[qi])
                if stream_token is not None and not stream_token(
                        qi, pos[qi] + 1, tok, prob):
                    tok = self.config.eos_id
                outputs[qi].append(tok)
                prev[qi] = tok
                pos[qi] += 1
                if self.config.is_eos(tok):
                    non_eos[qi] = False
            done += 1
        return outputs
