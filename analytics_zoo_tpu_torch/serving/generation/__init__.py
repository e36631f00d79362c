"""Continuous-batching generation engine of the port (counterpart of
analytics_zoo_tpu/serving/generation/): paged KV cache + block
allocator (kv_cache.py), slot scheduler with preemption and chunk mode
(scheduler.py), the radix-tree prefix cache (prefix_cache.py), the host
KV tier (host_tier.py), n-gram speculative drafting (speculation.py),
`CausalLM` (model.py), sampling (sampling.py) and the engine tying them
together (engine.py)."""

from analytics_zoo_tpu_torch.serving.errors import (  # noqa: F401
    QueueFull,
    RequestTooLarge,
)
from analytics_zoo_tpu_torch.serving.generation.engine import (  # noqa: F401,E501
    GenerationEngine,
    GenerationStream,
)
from analytics_zoo_tpu_torch.serving.generation.host_tier import (  # noqa: F401,E501
    HostKVTier,
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
from analytics_zoo_tpu_torch.serving.generation.prefix_cache import (  # noqa: F401,E501
    PrefixCache,
)
from analytics_zoo_tpu_torch.serving.generation.sampling import (  # noqa: F401,E501
    sample_tokens,
)
from analytics_zoo_tpu_torch.serving.generation.scheduler import (  # noqa: F401,E501
    Sequence,
    SlotScheduler,
)
from analytics_zoo_tpu_torch.serving.generation.speculation import (  # noqa: F401,E501
    SpecState,
    Speculator,
    ngram_draft,
)

__all__ = ["BlockAllocator", "CausalLM", "GPT2_SMALL", "GenerationEngine",
           "GenerationStream", "HostKVTier", "PagedKVCache", "PrefixCache",
           "QueueFull", "RequestTooLarge", "Sequence", "SlotScheduler",
           "SpecState", "Speculator", "dequantize_kv_tokens",
           "ngram_draft", "quantize_kv_tokens", "sample_tokens"]
