"""TimingInfo (counterpart of gemma_tpu/engine/timing.py; reference
gemma/gemma.h:169-229): prefill tok/s, time to first token, decode tok/s.

Durations are host wall-clock; the engine synchronizes the device before
it reads the clock, so they cover the device work they name."""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class TimingInfo:
    verbosity: int = 0
    prefill_start: float = 0.0
    generate_start: float = 0.0
    prefill_tokens: int = 0
    generated_tokens: int = 0
    decode_steps: int = 0
    # Host wall seconds per decode step: one entry per chunk of k steps
    # (each chunk ends in a device sync), its wall time over k.
    decode_step_seconds: list = dataclasses.field(default_factory=list)
    time_to_first_token: float = 0.0
    prefill_duration: float = 0.0
    generate_duration: float = 0.0

    def notify_prefill(self, tokens: int) -> None:
        self.prefill_duration = time.monotonic() - self.prefill_start
        self.prefill_tokens = tokens

    def notify_generated(self, num: int = 1) -> None:
        if self.generated_tokens == 0:
            self.time_to_first_token = time.monotonic() - self.prefill_start
            if self.verbosity >= 1:
                print(f"[ Timing ] Prefill: {self.prefill_tokens} tokens at "
                      f"{self.prefill_tokens_per_second:.1f} tok/s; "
                      f"TTFT {self.time_to_first_token:.3f}s")
        self.generated_tokens += num

    def notify_generate_done(self) -> None:
        self.generate_duration = time.monotonic() - self.generate_start
        if self.verbosity >= 1:
            print(f"[ Timing ] Generated {self.generated_tokens} tokens at "
                  f"{self.generate_tokens_per_second:.1f} tok/s")

    @property
    def prefill_tokens_per_second(self) -> float:
        return self.prefill_tokens / max(self.prefill_duration, 1e-9)

    @property
    def generate_tokens_per_second(self) -> float:
        return self.generated_tokens / max(self.generate_duration, 1e-9)
