from gemma_tpu_torch.engine.engine import GemmaEngine, RuntimeConfig  # noqa: F401
from gemma_tpu_torch.engine.timing import TimingInfo  # noqa: F401
