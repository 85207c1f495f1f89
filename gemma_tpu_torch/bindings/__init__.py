"""Embedding bindings (counterpart of gemma_tpu/bindings/; reference
gemma/bindings/): GemmaContext named-conversation management."""

from gemma_tpu_torch.bindings.context import ContextGemma, GemmaContext

__all__ = ["ContextGemma", "GemmaContext"]
