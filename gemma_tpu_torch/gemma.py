"""Top-level `Gemma` facade (counterpart of gemma_tpu/gemma.py; the
reference's class Gemma, gemma/gemma.{h,cc}:233-284).

Construction mirrors the reference ctor: BlobReader -> ModelStore (config,
tokenizer bytes, TOC) -> Params on the device -> engine.

    gemma = Gemma.load("model.sbs", kind_override="i4")
    ids = gemma.generate(prompt_ids, max_generated_tokens=64)

Everything lands on CUDA unless the caller passes `device="cpu"`.  The
file's tokenizer bytes are kept and written back by `save`, but the port
has no tokenizer yet: `generate_text` and `chat` raise.
"""

from __future__ import annotations

from typing import Sequence

from gemma_tpu_torch.engine.engine import GemmaEngine, RuntimeConfig
from gemma_tpu_torch.io.blob_store import BlobReader
from gemma_tpu_torch.io.model_store import ModelStore, write_model
from gemma_tpu_torch.models.configs import ModelConfig, PromptWrapping
from gemma_tpu_torch.models.gemma import Params, load_params
from gemma_tpu_torch.models.kv_cache import KVCache


class Gemma:
    """Owns the store-derived config, the params on the device and the
    engine."""

    def __init__(self, config: ModelConfig, params: Params,
                 runtime: RuntimeConfig | None = None,
                 store: ModelStore | None = None, device=None):
        self.config = config
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
        store = ModelStore(BlobReader(weights_path),
                           tokenizer_path=tokenizer_path, wrapping=wrapping)
        if store.config.vit_config.layer_configs and \
                "img_emb_kernel" in store.tensors:
            raise NotImplementedError(
                "this file holds ViT weights (img_emb_kernel): image input "
                "comes with the port's ViT slice (models/vit.py, ROADMAP "
                "queue 1); a file without them loads")
        params = load_params(store, kind_override=kind_override,
                             device=device)
        return cls(store.config, params, runtime, store, device=device)

    def save(self, path: str) -> None:
        """Gemma::Save analog (gemma/gemma.cc:655-661): single-file .sbs,
        the tensors and the tokenizer bytes as the store holds them."""
        if self._store is None:
            raise ValueError("save() requires a store-backed model")
        tensors = []
        for name in self._store.tensors:
            pt = self._store.read_tensor(name)
            if pt is not None:
                tensors.append(pt)
        write_model(path, self.config, tensors,
                    tokenizer_proto=self._store.tokenizer_bytes())

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

    def generate_text(self, prompt: str, **kw):
        raise NotImplementedError(
            "generate_text needs the tokenizer (sentencepiece), which the "
            "port gains with its frontends slice; pass token ids to "
            "generate / generate_batch")

    def chat(self, prompt: str, **kw) -> str:
        raise NotImplementedError(
            "chat needs the tokenizer and the chat template, which the port "
            "gains with its frontends slice; pass token ids to generate / "
            "generate_batch")
