"""Generation engine (counterpart of gemma_tpu/engine/engine.py; reference
gemma/gemma.{h,cc} GenerateT).

`GemmaEngine.generate_batch` prefills every prompt in token chunks
(ragged prompts share rounds, padded slots write the garbage row), then
decodes with streaming callbacks and EOS tracking, as the JAX engine does:
  - a chunk of k = min(decode_chunk, tokens left) > 1 steps runs
    `forward` k times with the tokens and positions kept on the device
    from step to step: `return_logits="top1"` (the fused greedy head, K3)
    when top_k == 1, else `return_logits="topk"` (the fused top-k head,
    K6) followed by the categorical draw on its [B, top_k] result
    (ops/sampling.py:sample_stream, one launch).  The [B, k] tokens and
    probs reach the host once, at the chunk's end, and the callbacks fire
    in a burst;
  - a one-step chunk (decode_chunk=1, the last token of a budget, or an
    `accept_token` constraint) runs `return_logits="last"` and picks on
    the logits (`_sample`).
A sampled token's draw comes from the stream of (seed, query index,
position of the new token), so it is the same in any batch, chunk size
or path (gemma.cc:470-477).
`generate_fast` is the benchmark loop: greedy steps through the fused
head with no host sync until the end.
Under GEMMA_SCAN_DECODE=1 (read once per engine, `scan_params`) every
decode step above runs `engine/scan_decode.py:forward_scan` over stacked
weights, where the model and the cache allow it; prefill stays unrolled.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Callable, Sequence

import numpy as np
import torch

from gemma_tpu_torch.engine.scan_decode import (build_scan_params,
                                                forward_scan, scan_plan)
from gemma_tpu_torch.engine.timing import TimingInfo
from gemma_tpu_torch.models.configs import ModelConfig
from gemma_tpu_torch.models.gemma import Params, forward
from gemma_tpu_torch.models.kv_cache import LOCAL_RING_SLACK, KVCache
from gemma_tpu_torch.ops import sampling
from gemma_tpu_torch.utils.basics import (resolve_device, sample_key,
                                          stream_uniform)

StreamFunc = Callable[[int, int, int, float], bool]
AcceptFunc = Callable[[int, float], bool]
KV_KINDS = ("bf16", "f32", "i8")


@dataclasses.dataclass
class RuntimeConfig:
    """Maps InferenceArgs/RuntimeConfig (gemma/gemma_args.h:114-265).

    Every field shared with gemma_tpu's RuntimeConfig has its default."""

    max_generated_tokens: int = 2048
    # 0 = auto: 1024 at batch 1, 512 at batch >= 2, capped to the next
    # power of two >= the prompt length (engine.py:332-347).
    prefill_tbatch_size: int = 0
    # Sampling: the top_k largest logits, their softmax raised to
    # 1/temperature (0 = argmax), drawn from the stream of `seed`.
    temperature: float = 1.0
    top_k: int = 1
    seed: int = 0
    seq_len: int = 8192
    # Decode steps per host round trip; streaming callbacks fire in bursts
    # of up to this many tokens (tokens equal stepwise decode's).
    decode_chunk: int = 4
    # KV cache element kind: "bf16", "f32" or "i8" (per-row scales).
    kv_kind: str = "bf16"
    # Greedy chunks compute the winner's softmax prob for the callbacks;
    # False skips the head's soft cap and exp sum (callbacks get 1.0).
    stream_probs: bool = True


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
        if not 1 <= rt.top_k <= config.vocab_size:
            raise ValueError(f"top_k={rt.top_k}: 1..{config.vocab_size}")
        if rt.kv_kind not in KV_KINDS:
            raise ValueError(f"kv_kind={rt.kv_kind!r}: one of {KV_KINDS}")
        if params.device.type != self.device.type:
            raise ValueError(f"params live on {params.device}, the engine "
                             f"runs on {self.device}")
        self.params = params

    @functools.cached_property
    def scan_params(self) -> Params | None:
        """Stacked [T, ...] params for the scan-over-layers decode
        (engine/scan_decode.py), built on first use when GEMMA_SCAN_DECODE
        is "1" (read once per engine, as engine.py:105-126 does).  None
        when the switch is off or the model cannot scan
        (`build_scan_params`)."""
        if os.environ.get("GEMMA_SCAN_DECODE", "0") != "1":
            return None
        return build_scan_params(self.params, self.config)

    def _decoder(self, cache: KVCache):
        """The decode step for `cache`: forward_scan over scan_params, or
        the unrolled forward when there are none or the cache's layer_map
        is not periodic-affine (decided before any launch; the scan's
        plan is made here, once for the steps that follow).  Called as
        fn(tokens, positions, cache, **forward's keywords)."""
        sp = self.scan_params
        plan = None if sp is None else scan_plan(sp, cache, self.config)
        if plan is not None:
            return lambda tok, pos, c, **kw: forward_scan(
                sp, tok, pos, c, self.config, plan=plan, **kw)
        return lambda tok, pos, c, **kw: forward(
            self.params, tok, pos, c, self.config, **kw)

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
                       accept_token: AcceptFunc | None = None,
                       allowed_tokens: Sequence[int] | None = None,
                       cache: KVCache | None = None,
                       start_pos: Sequence[int] | None = None,
                       prefix_end: Sequence[int] | None = None,
                       timing_info: TimingInfo | None = None
                       ) -> list[list[int]]:
        """Batched generation with EOS tracking (GenerateT, gemma.cc:488-568).

        allowed_tokens: the only tokens decode may pick (run_mmlu's
        TokenSet), one [vocab] mask on the device (the heads' mask);
        accept_token(token, logit): a per-candidate constraint, run on the
        host over the top candidates of one-step chunks, of which the
        top_k best accepted are sampled (engine.py:653-707)."""
        rt = self.runtime
        batch = len(prompts)
        max_gen = max_generated_tokens or rt.max_generated_tokens
        timing = timing_info or TimingInfo()
        start_pos = list(start_pos or [0] * batch)
        prefix_end = list(prefix_end or [0] * batch)
        if cache is None:
            cache = self.new_cache(batch, min_local_slack=max(prefix_end))
        allowed_mask = None
        if allowed_tokens is not None:
            m = torch.zeros(self.config.vocab_size, dtype=torch.bool)
            m[torch.as_tensor(sorted(allowed_tokens), dtype=torch.long)] = True
            allowed_mask = m.to(self.device)
        self._sync()
        timing.prefill_start = time.monotonic()
        try:
            return self._generate_loop(prompts, cache, start_pos, prefix_end,
                                       stream_token, accept_token, max_gen,
                                       timing, allowed_mask)
        finally:
            timing.notify_generate_done()

    def _generate_loop(self, prompts, cache, start_pos, prefix_end,
                       stream_token, accept_token, max_gen, timing,
                       allowed_mask):
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
        # Multi-step chunks when the host cannot influence tokens
        # mid-chunk; accept_token takes the one-step path (engine.py:606-608).
        chunk = max(1, self.runtime.decode_chunk)
        if accept_token is not None:
            chunk = 1
        step = self._decoder(cache)
        done = 0
        while done < max_gen and any(non_eos):
            k = min(chunk, max_gen - done)
            t_step = time.monotonic()
            if k == 1:
                logits, cache = step(
                    self._on_device(prev)[:, None],
                    self._on_device(pos)[:, None], cache,
                    return_logits="last")
                tokens, probs = self._sample(logits, pos, accept_token,
                                             allowed_mask)
                tokens, probs = tokens[:, None], probs[:, None]
            else:
                toks, prbs = self._decode_steps(
                    self._on_device(prev), self._on_device(pos), cache, k,
                    allowed_mask, self.runtime.stream_probs)
                tokens, probs = toks.cpu().numpy(), prbs.cpu().numpy()
            timing.decode_steps += k
            timing.decode_step_seconds.append((time.monotonic() - t_step) / k)
            for i in range(k):
                if not any(non_eos):
                    break
                timing.notify_generated(sum(non_eos))
                for qi in range(batch):
                    if not non_eos[qi]:
                        continue
                    tok, prob = int(tokens[qi, i]), float(probs[qi, i])
                    if stream_token is not None and not stream_token(
                            qi, pos[qi] + 1, tok, prob):
                        tok = self.config.eos_id
                    outputs[qi].append(tok)
                    prev[qi] = tok
                    pos[qi] += 1
                    if self.config.is_eos(tok):
                        non_eos[qi] = False
            done += k
        return outputs

    def _on_device(self, values) -> torch.Tensor:
        """int32 [B] copy of host values on the engine's device."""
        return torch.tensor(np.asarray(values, np.int32), device=self.device)

    def _decode_steps(self, prev: torch.Tensor, pos: torch.Tensor,
                      cache: KVCache, k: int, allowed_mask=None,
                      need_prob: bool = True, sampled: bool | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """k decode steps through a fused head (engine.py:243-307): greedy
        (K3), or, when `sampled` (by default: top_k > 1), the top-k head
        (K6) and a draw from the stream of (seed, row, pos + 1).

        prev, pos: int32 [B] on the device.  Each step's token and the
        advanced position feed the next step on the device: nothing here
        waits for the card.  Returns tokens int32 and probs f32 [B, k], on
        the device."""
        rt = self.runtime
        if sampled is None:
            sampled = rt.top_k > 1
        qi = torch.arange(prev.shape[0], dtype=torch.int32,
                          device=prev.device) if sampled else None
        step = self._decoder(cache)
        toks, probs = [], []
        for _ in range(k):
            nxt = pos + 1
            if sampled:
                (vals, idxs), cache = step(
                    prev[:, None], pos[:, None], cache, return_logits="topk",
                    top_k_n=rt.top_k, top1_mask=allowed_mask)
                tok, prob = sampling.sample_stream(
                    vals, idxs, rt.seed, qi, nxt, rt.temperature)
            else:
                (tok, prob), cache = step(
                    prev[:, None], pos[:, None], cache, return_logits="top1",
                    top1_mask=allowed_mask, top1_need_prob=need_prob)
            toks.append(tok)
            probs.append(prob)
            prev, pos = tok, nxt
        return torch.stack(toks, dim=1), torch.stack(probs, dim=1)

    def _sample(self, logits: torch.Tensor, pos: Sequence[int],
                accept_token: AcceptFunc | None,
                allowed_mask: torch.Tensor | None = None):
        """The one-step pick on [B, vocab] logits (engine.py:653-717):
        (tokens int32 [B], probs f32 [B]) on the host.  pos: each query's
        current position; the new token's stream is keyed by pos + 1."""
        rt = self.runtime
        if allowed_mask is not None:
            logits = torch.where(allowed_mask, logits, sampling.NEG_INF)
        if accept_token is None:
            if rt.top_k == 1:
                tokens, probs = sampling.top1(logits)
            else:
                bsz = logits.shape[0]
                keys = sample_key(
                    rt.seed, torch.arange(bsz, device=logits.device),
                    torch.as_tensor(np.asarray(pos, np.int64) + 1,
                                    device=logits.device))
                tokens, probs = sampling.make_sampler(
                    rt.top_k, rt.temperature)(logits, keys)
            return tokens.cpu().numpy(), probs.cpu().numpy()
        # Candidate-restricted constraint: evaluate only the top
        # candidates, widening on rejection; only the top_k best accepted
        # tokens can be picked, so the result equals the reference's
        # per-token accept_token inside TopK (ops-inl.h:1336-1362).
        arr = logits.float().cpu().numpy()
        bsz, vocab = arr.shape
        k = rt.top_k
        out_t = np.zeros(bsz, np.int32)
        out_p = np.zeros(bsz, np.float32)
        for qi in range(bsz):
            row = arr[qi]
            cand = min(vocab, max(64, 8 * k))
            while True:
                part = np.argpartition(row, -cand)[-cand:]
                order = part[np.argsort(row[part])[::-1]]
                accepted = [int(t) for t in order
                            if accept_token(int(t), float(row[t]))]
                if len(accepted) >= k or cand == vocab:
                    break
                cand = min(vocab, cand * 8)
            if not accepted:
                # Nothing accepted anywhere: fall back to the argmax.
                accepted = [int(order[0])]
            accepted = accepted[:k]
            # FusedSoftmaxAndSampleTopK (ops-inl.h:1375-1398): softmax over
            # the top-k accepted logits only.
            lg = row[accepted]
            e = np.exp(lg - lg.max())
            probs = e / e.sum()
            if k == 1 or rt.temperature == 0.0:
                j = 0  # accepted is sorted by logit, descending
            else:
                p = probs ** (1.0 / rt.temperature)
                p /= p.sum()
                u = float(stream_uniform(
                    sample_key(rt.seed, qi, pos[qi] + 1), 1)[0])
                j = min(int(np.searchsorted(np.cumsum(p), u)),
                        len(accepted) - 1)
            out_t[qi] = accepted[j]
            out_p[qi] = float(probs[j])
        return out_t, out_p

    def generate_fast(self, prompts: Sequence[Sequence[int]],
                      max_steps: int) -> np.ndarray:
        """Greedy decode for benchmarks (engine.py:721-788): prefill, then
        `max_steps` steps through the fused head with no host sync between
        steps, no EOS exit and no streaming.  Returns [batch, max_steps]
        tokens."""
        batch = len(prompts)
        cache = self.new_cache(batch)
        cache, last_tokens = self.prefill(prompts, cache)
        pos0 = [len(p) - 1 for p in prompts]
        tokens, _ = self._decode_steps(self._on_device(last_tokens),
                                       self._on_device(pos0), cache,
                                       max_steps, sampled=False)
        return tokens.cpu().numpy()
