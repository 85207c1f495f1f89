"""Top-level `Gemma` facade (counterpart of gemma_tpu/gemma.py; the
reference's class Gemma, gemma/gemma.{h,cc}:233-284).

Construction mirrors the reference ctor: BlobReader -> ModelStore (config,
tokenizer bytes, TOC) -> Params on the device -> engine.

    gemma = Gemma.load("model.sbs")
    text = gemma.chat("Hi!")                    # IT models
    text, n_in, n_out = gemma.generate_text("2+2=")
    ids = gemma.generate(prompt_ids, max_generated_tokens=64)

Everything lands on CUDA unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

from typing import Callable, Sequence

from gemma_tpu_torch.engine.engine import GemmaEngine, RuntimeConfig
from gemma_tpu_torch.engine.timing import TimingInfo
from gemma_tpu_torch.io.blob_store import BlobReader
from gemma_tpu_torch.io.model_store import ModelStore, write_model
from gemma_tpu_torch.models.configs import ModelConfig, PromptWrapping
from gemma_tpu_torch.models.gemma import Params, load_params
from gemma_tpu_torch.models.kv_cache import KVCache
from gemma_tpu_torch.models.tokenizer import (ChatTemplate, GemmaTokenizer,
                                              wrap_and_tokenize)
from gemma_tpu_torch.utils import profiler


class Gemma:
    """Owns the store-derived config, the tokenizer, the params on the
    device and the engine."""

    def __init__(self, config: ModelConfig, params: Params,
                 tokenizer: GemmaTokenizer,
                 runtime: RuntimeConfig | None = None,
                 store: ModelStore | None = None, device=None):
        self.config = config
        self.tokenizer = tokenizer
        self.chat_template = ChatTemplate(tokenizer)
        self.engine = GemmaEngine(params, config, runtime, device=device)
        self.params = self.engine.params
        self._store = store

    # --- construction ---

    @classmethod
    def load(cls, weights_path: str, tokenizer_path: str | None = None,
             kind_override: str | None = None,
             runtime: RuntimeConfig | None = None,
             wrapping: PromptWrapping | None = None,
             device=None) -> "Gemma":
        """Load a .sbs model file (single-file or pre-2025 + tokenizer)
        onto `device` (CUDA unless the caller names one).  A VLM file
        with ViT weights raises NotImplementedError: the port has no
        image path yet (gemma_tpu/gemma.py:60-64 loads them)."""
        with profiler.zone("Startup.open"):
            store = ModelStore(BlobReader(weights_path),
                               tokenizer_path=tokenizer_path,
                               wrapping=wrapping)
        if store.config.vit_config.layer_configs and \
                "img_emb_kernel" in store.tensors:
            raise NotImplementedError(
                "this file holds ViT weights (img_emb_kernel): image input "
                "comes with the port's ViT slice (models/vit.py, ROADMAP "
                "queue 4); a file without them loads")
        with profiler.zone("Startup.weights"):
            params = load_params(store, kind_override=kind_override,
                                 device=device)
        with profiler.zone("Startup.tokenizer"):
            tokenizer = GemmaTokenizer(store.tokenizer_bytes())
        return cls(store.config, params, tokenizer, runtime, store,
                   device=device)

    def save(self, path: str) -> None:
        """Gemma::Save analog (gemma/gemma.cc:655-661): single-file .sbs,
        the tensors as the store holds them and the tokenizer's bytes."""
        if self._store is None:
            raise ValueError("save() requires a store-backed model")
        tensors = []
        for name in self._store.tensors:
            pt = self._store.read_tensor(name)
            if pt is not None:
                tensors.append(pt)
        write_model(path, self.config, tensors,
                    tokenizer_proto=self.tokenizer.serialize())

    # --- generation ---

    @property
    def runtime(self) -> RuntimeConfig:
        return self.engine.runtime

    def new_cache(self, batch: int = 1, seq_len: int | None = None,
                  min_local_slack: int = 0) -> KVCache:
        return self.engine.new_cache(batch, seq_len,
                                     min_local_slack=min_local_slack)

    def generate(self, prompt_ids: Sequence[int], **kw) -> list[int]:
        return self.engine.generate(prompt_ids, **kw)

    def generate_batch(self, prompts: Sequence[Sequence[int]], **kw):
        return self.engine.generate_batch(prompts, **kw)

    def generate_text(
        self,
        prompt: str,
        pos: int = 0,
        max_generated_tokens: int | None = None,
        stream: Callable[[str], bool] | None = None,
        cache: KVCache | None = None,
        timing_info: TimingInfo | None = None,
        image_batch_size: int | None = None,
    ) -> tuple[str, int, int]:
        """Wrap + tokenize + generate + detokenize (run.cc ReplGemma path):
        (text, prompt tokens, generated tokens without EOS)."""
        if image_batch_size is not None:
            raise NotImplementedError(
                "image prompts need the port's ViT (ROADMAP queue 4)")
        ids = wrap_and_tokenize(self.tokenizer, self.chat_template,
                                self.config.wrapping, pos, prompt)
        out_ids: list[int] = []

        def stream_token(qi: int, p: int, token: int, prob: float) -> bool:
            if p < pos + len(ids):
                return True  # prompt tokens
            if self.config.is_eos(token):
                return True
            out_ids.append(token)
            if stream is not None:
                return stream(self.tokenizer.decode([token]))
            return True

        self.engine.generate(
            ids, max_generated_tokens=max_generated_tokens,
            stream_token=stream_token, cache=cache, start_pos=pos,
            timing_info=timing_info)
        return self.tokenizer.decode(out_ids), len(ids), len(out_ids)

    def chat(self, prompt: str, **kw) -> str:
        text, _, _ = self.generate_text(prompt, **kw)
        return text
