"""GemmaContext — named multi-conversation management (counterpart of
gemma_tpu/bindings/context.py; reference gemma/bindings/context.{h,cc}:41-166).

Each conversation owns a KVCache + abs_pos; `save_conversation` keeps a
deep copy in a prewarm cache that `reset_conversation` restores (the
reference's prewarmed_cache protocol).  `ContextGemma` is another name for
the class.  The model runs on CUDA unless `create` is given a device.
Image prompts wait for the port's ViT (ROADMAP.md queue 4), and a C ABI
over this class for the port waits too (queue 2): native/c_api.cc drives
the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from gemma_tpu_torch.engine.engine import RuntimeConfig
from gemma_tpu_torch.gemma import Gemma
from gemma_tpu_torch.models.kv_cache import KVCache
from gemma_tpu_torch.models.tokenizer import wrap_and_tokenize


@dataclasses.dataclass
class ConversationData:
    """bindings/context.h:41-49."""

    cache: KVCache
    abs_pos: int = 0

    def copy(self) -> "ConversationData":
        return ConversationData(self.cache.copy(), self.abs_pos)


class GemmaContext:
    _log_callback: Callable[[str], None] | None = None

    def __init__(self, gemma: Gemma):
        self.gemma = gemma
        self._conversations: dict[str, ConversationData] = {}
        self._prewarmed: dict[str, ConversationData] = {}
        self.active_name = "default"
        self._conversations["default"] = self._new_conversation()

    # --- construction (GemmaContext::Create) ---

    @classmethod
    def create(cls, weights_path: str, tokenizer_path: str | None = None,
               max_generated_tokens: int = 2048,
               device=None) -> "GemmaContext":
        runtime = RuntimeConfig(max_generated_tokens=max_generated_tokens)
        gemma = Gemma.load(weights_path, tokenizer_path=tokenizer_path,
                           runtime=runtime, device=device)
        return cls(gemma)

    @classmethod
    def set_log_callback(cls, callback: Callable[[str], None] | None) -> None:
        cls._log_callback = callback

    @classmethod
    def _log(cls, msg: str) -> None:
        if cls._log_callback is not None:
            cls._log_callback(msg)

    def _new_conversation(self) -> ConversationData:
        return ConversationData(
            self.gemma.new_cache(1, self.gemma.runtime.seq_len))

    @property
    def active(self) -> ConversationData:
        return self._conversations[self.active_name]

    # --- settings (context.h:84-118) ---

    def set_max_generated_tokens(self, value: int) -> None:
        self.gemma.runtime.max_generated_tokens = value

    def set_multiturn(self, value: int) -> None:
        self.multiturn = bool(value)

    def set_temperature(self, value: float) -> None:
        self.gemma.runtime.temperature = value

    def set_top_k(self, value: int) -> None:
        self.gemma.runtime.top_k = value

    def set_deterministic(self, value: bool) -> None:
        self.gemma.runtime.seed = 0

    def set_prefill_tbatch_size(self, value: int) -> None:
        self.gemma.runtime.prefill_tbatch_size = value

    multiturn: bool = False

    # --- conversation management ---

    def create_conversation(self, name: str) -> bool:
        if name in self._conversations:
            self._log(f"CreateConversation: '{name}' already exists")
            return False
        self._conversations[name] = self._new_conversation()
        return True

    def switch_conversation(self, name: str) -> bool:
        if name not in self._conversations:
            self._log(f"SwitchConversation: '{name}' not found")
            return False
        self.active_name = name
        return True

    def delete_conversation(self, name: str) -> bool:
        if name == "default" or name not in self._conversations:
            return False
        del self._conversations[name]
        self._prewarmed.pop(name, None)
        if self.active_name == name:
            self.active_name = "default"
        return True

    def has_conversation(self, name: str) -> bool:
        return name in self._conversations

    def current_conversation(self) -> str:
        return self.active_name

    def save_conversation(self) -> None:
        """Deep-copy the active conversation into the prewarm cache."""
        self._prewarmed[self.active_name] = self.active.copy()
        self._log(f"SaveConversation: saved '{self.active_name}'")

    def reset_conversation(self) -> None:
        """Restore from the prewarm cache if present, else start fresh."""
        pre = self._prewarmed.get(self.active_name)
        if pre is not None:
            self._conversations[self.active_name] = pre.copy()
            self._log(f"ResetConversation: restored '{self.active_name}'")
        else:
            self._conversations[self.active_name] = self._new_conversation()
            self._log(f"ResetConversation: fresh '{self.active_name}'")

    # --- generation (context.cc Generate/GenerateMultimodal) ---

    def generate(self, prompt: str,
                 callback: Callable[[str], bool] | None = None,
                 image=None) -> str:
        if image is not None:
            raise NotImplementedError(
                "image input needs the port's ViT (ROADMAP.md queue 4)")
        gemma = self.gemma
        conv = self.active
        pos = conv.abs_pos
        ids = wrap_and_tokenize(gemma.tokenizer, gemma.chat_template,
                                gemma.config.wrapping, pos, prompt)
        if pos > 0:
            pos -= 1

        pieces: list[str] = []
        state = {"generated": 0, "abs_pos": pos}

        def stream_token(qi, p, token, prob):
            state["abs_pos"] += 1
            in_prompt = state["generated"] < len(ids)
            state["generated"] += 1
            if in_prompt or gemma.config.is_eos(token):
                return True
            text = gemma.tokenizer.decode([token])
            pieces.append(text)
            if callback is not None:
                return callback(text)
            return True

        gemma.engine.generate(ids, stream_token=stream_token,
                              cache=conv.cache, start_pos=pos)
        if self.multiturn:
            conv.abs_pos = max(state["abs_pos"] - 1, 0)
        else:
            conv.abs_pos = 0
        return "".join(pieces)

    def count_tokens(self, text: str) -> int:
        return len(self.gemma.tokenizer.encode(text))


ContextGemma = GemmaContext
