"""Interactive REPL frontend (counterpart of gemma_tpu/run.py; reference
gemma/run.cc:92-316).

    python -m gemma_tpu_torch.run --weights model.sbs [--tokenizer tok.model] \
        [--prompt "..."] [--multiturn 1] [--device cpu]

Behavior parity with the reference REPL: multiturn position tracking with
rewind-by-1 between turns, `%q` quit / `%c` reset commands, verbosity
levels, dots during prefill and the timing lines.  The model runs on CUDA
unless `--device` names another device.  `--image_file` raises: image
prompts need the port's ViT (ROADMAP.md queue 4).
"""

from __future__ import annotations

import argparse
import sys

from gemma_tpu_torch.args import (
    InferenceArgs,
    LoaderArgs,
    add_args,
    extract,
    load_gemma,
)
from gemma_tpu_torch.engine.timing import TimingInfo
from gemma_tpu_torch.models.configs import PromptWrapping
from gemma_tpu_torch.models.tokenizer import wrap_and_tokenize

BANNER = r"""
  __ _  ___ _ __ ___  _ __ ___   __ _   _ __ _   _
 / _` |/ _ \ '_ ` _ \| '_ ` _ \ / _` | | '__| | | |
| (_| |  __/ | | | | | | | | | | (_| |_| |  | |_| |
 \__, |\___|_| |_| |_|_| |_| |_|\__,_(_)_|   \__,_|
  __/ |                          gemma on pytorch
 |___/
"""


def get_prompt(inference: InferenceArgs) -> str | None:
    if inference.prompt:
        return inference.prompt
    if inference.prompt_file:
        with open(inference.prompt_file) as f:
            return f.read()
    try:
        if inference.eot_line:
            lines = []
            print("> ", end="", flush=True)
            for line in sys.stdin:
                if line.rstrip("\n") == inference.eot_line:
                    break
                lines.append(line)
            return "".join(lines)
        print("> ", end="", flush=True)
        line = sys.stdin.readline()
        if not line:
            return None
        return line.rstrip("\n")
    except KeyboardInterrupt:
        return None


def repl(gemma, inference: InferenceArgs) -> None:
    config = gemma.config
    abs_pos = 0
    cache = gemma.new_cache(1, inference.seq_len)
    interactive = not (inference.prompt or inference.prompt_file)
    if inference.image_file:
        raise NotImplementedError(
            "--image_file needs the port's ViT (ROADMAP.md queue 4)")

    while True:
        prompt_string = get_prompt(inference)
        if prompt_string is None:
            return
        if interactive:
            if len(prompt_string) >= 2 and prompt_string[0] == "%":
                if prompt_string[1] in "qQ":
                    return
                if prompt_string[1] in "cC":
                    abs_pos = 0
                    continue
            if not prompt_string:
                print("Use '%q' to quit.")
                continue

        prompt = wrap_and_tokenize(gemma.tokenizer, gemma.chat_template,
                                   config.wrapping, abs_pos, prompt_string)
        prompt_size = len(prompt)

        if inference.verbosity >= 1:
            print("\n[ Reading prompt ] ", end="", file=sys.stderr, flush=True)
        if abs_pos > 0:
            abs_pos -= 1

        state = {"generated": 0, "abs_pos": abs_pos}

        def stream_token(qi: int, pos: int, token: int, prob: float) -> bool:
            state["abs_pos"] += 1
            in_prompt = state["generated"] < prompt_size
            first = state["generated"] == prompt_size
            state["generated"] += 1
            if in_prompt:
                if inference.verbosity >= 1:
                    print(".", end="", file=sys.stderr, flush=True)
                return True
            if config.is_eos(token):
                if inference.verbosity >= 2:
                    print("\n[ End ]")
                return True
            text = gemma.tokenizer.decode([token])
            if first:
                text = text.lstrip(" \t\n")
                if inference.verbosity >= 1:
                    print("\n")
            print(text, end="", flush=True)
            return True

        timing = TimingInfo(verbosity=inference.verbosity)
        gemma.engine.generate(prompt, stream_token=stream_token, cache=cache,
                              start_pos=abs_pos, timing_info=timing)
        abs_pos = state["abs_pos"]
        print("\n")

        if not interactive:
            break
        if not inference.multiturn or config.wrapping == PromptWrapping.PALIGEMMA:
            abs_pos = 0
        else:
            assert abs_pos > 0
            abs_pos -= 1


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="gemma_tpu_torch REPL")
    add_args(parser, LoaderArgs, InferenceArgs)
    ns = parser.parse_args(argv)
    loader = extract(ns, LoaderArgs)
    inference = extract(ns, InferenceArgs)
    if not loader.weights:
        parser.error("--weights is required")

    interactive = not (inference.prompt or inference.prompt_file)
    if inference.verbosity >= 1 and interactive:
        print(BANNER)
        print("*Usage*\n  Enter an instruction and press enter "
              "(%C resets conversation, %Q quits).\n")

    gemma = load_gemma(loader, inference)
    if inference.verbosity >= 1 and interactive:
        from gemma_tpu_torch.evals.benchmark_helper import show_config

        show_config(gemma)
        print()
    repl(gemma, inference)
    if inference.verbosity >= 2:
        from gemma_tpu_torch.utils import profiler

        profiler.print_results()


if __name__ == "__main__":
    main()
