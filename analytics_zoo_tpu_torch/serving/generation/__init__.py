"""Continuous-batching generation engine of the port (counterpart of
analytics_zoo_tpu/serving/generation/): paged KV cache + block
allocator (kv_cache.py), slot scheduler with preemption
(scheduler.py), `CausalLM` (model.py), sampling (sampling.py) and the
engine tying them together (engine.py)."""

from analytics_zoo_tpu_torch.serving.errors import (  # noqa: F401
    QueueFull,
    RequestTooLarge,
)
from analytics_zoo_tpu_torch.serving.generation.engine import (  # noqa: F401,E501
    GenerationEngine,
    GenerationStream,
)
from analytics_zoo_tpu_torch.serving.generation.kv_cache import (  # noqa: F401,E501
    BlockAllocator,
    PagedKVCache,
    dequantize_kv_tokens,
    quantize_kv_tokens,
)
from analytics_zoo_tpu_torch.serving.generation.model import (  # noqa: F401
    GPT2_SMALL,
    CausalLM,
)
from analytics_zoo_tpu_torch.serving.generation.sampling import (  # noqa: F401,E501
    sample_tokens,
)
from analytics_zoo_tpu_torch.serving.generation.scheduler import (  # noqa: F401,E501
    Sequence,
    SlotScheduler,
)

__all__ = ["BlockAllocator", "CausalLM", "GPT2_SMALL", "GenerationEngine",
           "GenerationStream", "PagedKVCache", "QueueFull",
           "RequestTooLarge", "Sequence", "SlotScheduler",
           "dequantize_kv_tokens", "quantize_kv_tokens", "sample_tokens"]
