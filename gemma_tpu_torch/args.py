"""CLI argument groups (counterpart of gemma_tpu/args.py; reference
util/args.h ArgsBase + gemma/gemma_args.h).

The reference declares each flag once in a ForEach(visitor); here each
group is a dataclass whose fields carry (default, help) metadata, with one
function wiring any set of groups into argparse.  The JAX package's mesh
group (`ShardingArgs`: num_devices, data_parallel, model_parallel) waits
for the port's `parallel/` (ROADMAP.md queue 5); `LoaderArgs.device`
takes its place for the one card.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Type


def field(default: Any, help_: str, **kw):
    return dataclasses.field(default=default, metadata={"help": help_}, **kw)


@dataclasses.dataclass
class LoaderArgs:
    """gemma/gemma_args.h:37-65."""

    weights: str = field("", "Path to model weights (.sbs) file")
    tokenizer: str = field("", "Path to tokenizer file (if not in weights)")
    to_bf16: bool = field(False, "Decompress weights to bf16 on load")
    kind: str = field("", "Override device codec: bf16|f32|i8|i4|nuq4")
    wrapping: str = field("", "Override prompt wrapping: pt|it|vlm|pali")
    device: str = field("", "torch device to run on ('' = cuda; cpu runs "
                            "the plain PyTorch path)")


@dataclasses.dataclass
class InferenceArgs:
    """gemma/gemma_args.h:164-265."""

    seq_len: int = field(8192, "KV cache sequence length")
    max_generated_tokens: int = field(2048, "Max tokens to generate")
    prefill_tbatch_size: int = field(
        0, "Prefill token batch size (0 = auto by batch: 1024 at batch 1, "
           "512 at batch >= 2)")
    decode_qbatch_size: int = field(16, "Decode query batch size")
    temperature: float = field(1.0, "Sampling temperature")
    top_k: int = field(1, "Top-K sampling (1 = greedy)")
    deterministic: bool = field(False, "Deterministic sampling seed")
    seed: int = field(0, "Sampling seed")
    multiturn: int = field(0, "1 = keep conversation KV across turns")
    image_file: str = field("", "PPM image for PaliGemma/Gemma3 prompts")
    prompt: str = field("", "Prompt (non-interactive mode)")
    prompt_file: str = field("", "File containing the prompt")
    eot_line: str = field("", "End-of-turn line marker for multiline input")
    verbosity: int = field(1, "0=min output, 1=standard, 2=debug")
    kv_kind: str = field("bf16", "KV cache element kind: bf16|f32|i8")


def add_args(parser: argparse.ArgumentParser, *groups: Type) -> None:
    for group in groups:
        g = parser.add_argument_group(group.__name__)
        for f in dataclasses.fields(group):
            name = "--" + f.name
            default = f.default
            help_ = f.metadata.get("help", "")
            if f.type in ("bool", bool):
                g.add_argument(name, type=lambda s: s.lower() in
                               ("1", "true", "yes", "on"),
                               default=default, help=help_)
            else:
                typ = {"int": int, "float": float, "str": str}.get(
                    f.type if isinstance(f.type, str) else f.type.__name__, str)
                g.add_argument(name, type=typ, default=default, help=help_)


def extract(ns: argparse.Namespace, group: Type):
    return group(**{f.name: getattr(ns, f.name)
                    for f in dataclasses.fields(group)})


def runtime_from_args(inf: InferenceArgs):
    from gemma_tpu_torch.engine.engine import RuntimeConfig

    return RuntimeConfig(
        max_generated_tokens=inf.max_generated_tokens,
        prefill_tbatch_size=inf.prefill_tbatch_size,
        decode_qbatch_size=inf.decode_qbatch_size,
        temperature=inf.temperature,
        top_k=inf.top_k,
        seed=inf.seed,
        verbosity=inf.verbosity,
        seq_len=inf.seq_len,
        kv_kind=inf.kv_kind,
    )


def load_gemma(loader: LoaderArgs, inf: InferenceArgs):
    """Gemma.load on CUDA, or on `loader.device` when it names one."""
    from gemma_tpu_torch.gemma import Gemma
    from gemma_tpu_torch.models.configs import PromptWrapping

    wrapping = {
        "": None,
        "pt": PromptWrapping.GEMMA_PT,
        "it": PromptWrapping.GEMMA_IT,
        "vlm": PromptWrapping.GEMMA_VLM,
        "pali": PromptWrapping.PALIGEMMA,
    }[loader.wrapping]
    kind = "bf16" if loader.to_bf16 else (loader.kind or None)
    return Gemma.load(
        loader.weights,
        tokenizer_path=loader.tokenizer or None,
        kind_override=kind,
        runtime=runtime_from_args(inf),
        wrapping=wrapping,
        device=loader.device or None,
    )
