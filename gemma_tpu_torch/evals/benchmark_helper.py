"""GemmaEnv — the universal eval/benchmark fixture (counterpart of
gemma_tpu/evals/benchmark_helper.py; reference
evals/benchmark_helper.{h,cc}:51-143).

`cross_entropy` waits for the port's `forward_collect` and
`evals/cross_entropy.py` (ROADMAP.md queue 3) and raises until then.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

from gemma_tpu_torch.models.tokenizer import BOS_ID, wrap_and_tokenize


@dataclasses.dataclass
class QueryResult:
    response: str = ""
    response_start_pos: int = 0
    tokens_generated: int = 0


class GemmaEnv:
    """Wraps a Gemma facade with tokenize/query helpers."""

    def __init__(self, gemma):
        self.gemma = gemma

    @classmethod
    def from_argv(cls, argv=None) -> "GemmaEnv":
        import argparse

        from gemma_tpu_torch.args import (InferenceArgs, LoaderArgs,
                                          add_args, extract, load_gemma)

        parser = argparse.ArgumentParser()
        add_args(parser, LoaderArgs, InferenceArgs)
        ns, _ = parser.parse_known_args(argv)
        return cls(load_gemma(extract(ns, LoaderArgs),
                              extract(ns, InferenceArgs)))

    # --- tokenization helpers (benchmark_helper.h:67-88) ---

    def tokenize(self, text: str) -> list[int]:
        return self.gemma.tokenizer.encode(text)

    def tokenize_and_prepend_bos(self, text: str) -> list[int]:
        return [BOS_ID] + self.tokenize(text)

    def wrap_and_tokenize(self, text: str, pos: int = 0) -> list[int]:
        g = self.gemma
        return wrap_and_tokenize(g.tokenizer, g.chat_template,
                                 g.config.wrapping, pos, text)

    def string_from_tokens(self, tokens: Sequence[int]) -> str:
        return self.gemma.tokenizer.decode(tokens)

    # --- queries (benchmark_helper.h:90-133) ---

    def query_model(self, input_text: str,
                    max_generated_tokens: int | None = None) -> QueryResult:
        prompt = self.wrap_and_tokenize(input_text)
        return self.query_model_tokens(prompt, max_generated_tokens)

    def query_model_tokens(self, prompt: Sequence[int],
                           max_generated_tokens: int | None = None
                           ) -> QueryResult:
        out = self.gemma.generate(
            prompt, max_generated_tokens=max_generated_tokens)
        reply = [t for t in out if not self.gemma.config.is_eos(t)]
        return QueryResult(
            response=self.string_from_tokens(reply),
            response_start_pos=len(prompt),
            tokens_generated=len(out),
        )

    def batch_query_model(self, inputs: Sequence[str],
                          max_generated_tokens: int | None = None
                          ) -> list[QueryResult]:
        prompts = [self.wrap_and_tokenize(s) for s in inputs]
        return self.batch_query_model_tokens(prompts, max_generated_tokens)

    def batch_query_model_tokens(self, prompts, max_generated_tokens=None
                                 ) -> list[QueryResult]:
        outs = self.gemma.generate_batch(
            prompts, max_generated_tokens=max_generated_tokens)
        results = []
        for prompt, out in zip(prompts, outs):
            reply = [t for t in out if not self.gemma.config.is_eos(t)]
            results.append(QueryResult(
                response=self.string_from_tokens(reply),
                response_start_pos=len(prompt),
                tokens_generated=len(out),
            ))
        return results

    def cross_entropy(self, text: str) -> float:
        """Bits per input byte (benchmark_helper.cc:178-185)."""
        raise NotImplementedError(
            "cross_entropy needs the port's forward_collect and "
            "evals/cross_entropy.py (ROADMAP.md queue 3)")


def log_speed_stats(time_start: float, total_tokens: int) -> None:
    """LogSpeedStats (benchmark_helper.cc:187-193)."""
    elapsed = time.monotonic() - time_start
    tok_sec = total_tokens / max(elapsed, 1e-9)
    print(f"{total_tokens} tokens in {elapsed:.3f} seconds "
          f"[{tok_sec:.2f} tokens / sec]")


def show_config(gemma) -> None:
    """ShowConfig analog (benchmark_helper.cc): model + device summary."""
    import torch

    config = gemma.config
    lc = config.layer_configs[0]
    dev = gemma.engine.device
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
        devices = f"{torch.cuda.device_count()} x {name} (cuda)"
    else:
        devices = f"{dev} (plain PyTorch path)"
    weight_kind = gemma.params.embedding.kind if gemma.params else "?"
    print(f"Model          : {config.display_name or config.specifier()}")
    print(f"Layers         : {len(config.layer_configs)}  "
          f"model_dim {config.model_dim}  vocab {config.vocab_size}")
    print(f"Heads          : {lc.heads} q / {lc.kv_heads} kv x "
          f"{lc.qkv_dim}d  ff {lc.ff_hidden_dim}")
    print(f"Max seq        : {config.max_seq_len}  "
          f"windows {sorted(set(config.attention_window_sizes))}")
    print(f"Weights        : {weight_kind}")
    print(f"Devices        : {devices}")
    print(f"Wrapping       : {config.wrapping.name}")
