"""`GemmaModel` — drop-in analog of the reference's pybind11 Python API
(counterpart of gemma_tpu/gemma_py.py; reference python/gemma_py.cc:46-290):
snake_case methods generate / generate_ex / generate_batch / tokenize /
detokenize with accept-token constraints and streaming callbacks.

    from gemma_tpu_torch.gemma_py import GemmaModel
    model = GemmaModel("tokenizer.model", "weights.sbs")
    print(model.generate("Hi", max_generated_tokens=64))

The model runs on CUDA unless `device` names another device.  The image
methods wait for the port's ViT (ROADMAP.md queue 4) and `cross_entropy`
for its forward_collect (queue 3); they raise.
"""

from __future__ import annotations

from typing import Callable, Sequence

from gemma_tpu_torch.engine.engine import RuntimeConfig
from gemma_tpu_torch.gemma import Gemma
from gemma_tpu_torch.models.tokenizer import wrap_and_tokenize


class GemmaModel:
    def __init__(self, tokenizer_path: str, weights_path: str,
                 max_generated_tokens: int = 2048, seq_len: int = 8192,
                 device=None):
        self._gemma = Gemma.load(
            weights_path, tokenizer_path=tokenizer_path or None,
            runtime=RuntimeConfig(max_generated_tokens=max_generated_tokens,
                                  seq_len=seq_len),
            device=device)

    # --- text generation (gemma_py.cc:53-160) ---

    def generate_ex(self, prompt: str,
                    stream: Callable[[int, float], bool] | None = None,
                    accept: Callable[[int, float], bool] | None = None,
                    max_generated_tokens: int = 1024,
                    temperature: float = 1.0, top_k: int = 1,
                    seed: int = 0) -> list[int]:
        """Streaming generation with optional accept-token constraints;
        returns the generated token ids."""
        g = self._gemma
        rt = g.runtime
        old = (rt.temperature, rt.top_k, rt.seed)
        rt.temperature, rt.top_k, rt.seed = temperature, top_k, seed
        try:
            ids = wrap_and_tokenize(g.tokenizer, g.chat_template,
                                    g.config.wrapping, 0, prompt)

            def stream_token(qi, pos, token, prob):
                if stream is not None:
                    return stream(token, prob)
                return True

            return g.generate(
                ids, max_generated_tokens=max_generated_tokens,
                stream_token=stream_token if stream else None,
                accept_token=(lambda t, l: accept(t, l)) if accept else None,
            )
        finally:
            rt.temperature, rt.top_k, rt.seed = old

    def generate(self, prompt: str, max_generated_tokens: int = 1024,
                 temperature: float = 1.0, top_k: int = 1,
                 seed: int = 0) -> str:
        g = self._gemma
        out = self.generate_ex(prompt,
                               max_generated_tokens=max_generated_tokens,
                               temperature=temperature, top_k=top_k,
                               seed=seed)
        return g.tokenizer.decode(
            [t for t in out if not g.config.is_eos(t)])

    def generate_batch(self, inputs: Sequence[str],
                       max_generated_tokens: int = 1024) -> list[str]:
        g = self._gemma
        prompts = [wrap_and_tokenize(g.tokenizer, g.chat_template,
                                     g.config.wrapping, 0, p)
                   for p in inputs]
        outs = g.generate_batch(prompts,
                                max_generated_tokens=max_generated_tokens)
        return [g.tokenizer.decode([t for t in out
                                    if not g.config.is_eos(t)])
                for out in outs]

    # --- vision (gemma_py.cc:163-230) ---

    def set_image(self, image) -> None:
        raise NotImplementedError(
            "image input needs the port's ViT (ROADMAP.md queue 4)")

    def generate_with_image(self, prompt: str,
                            max_generated_tokens: int = 1024
                            ) -> tuple[str, list[int]]:
        raise NotImplementedError(
            "image input needs the port's ViT (ROADMAP.md queue 4)")

    # --- evaluation ---

    def cross_entropy(self, text: str) -> float:
        """Bits per byte (evals/cross_entropy.cc semantics)."""
        from gemma_tpu_torch.evals.benchmark_helper import GemmaEnv

        return GemmaEnv(self._gemma).cross_entropy(text)

    def detokenize(self, ids: Sequence[int]) -> str:
        return self._gemma.tokenizer.decode(list(ids))

    def tokenize(self, text: str) -> list[int]:
        return self._gemma.tokenizer.encode(text)
