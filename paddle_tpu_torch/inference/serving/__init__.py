"""LLM serving: paged KV cache, ragged attention, continuous batching."""
from .attention import (RaggedCacheView, RaggedLayerCache, kv_cache_scatter,
                        kv_cache_scatter_quant, ragged_attention)
from .engine import (ENV_KV_DTYPE, ENV_WEIGHT_DTYPE, GenerationEngine,
                     sample_next)
from .errors import (RequestRejected, ServingError, ServingStepTimeout,
                     ServingUnavailable)
from .kv_cache import PagedKVCache
from .scheduler import (AdmissionPolicy, ContinuousBatchingScheduler,
                        PrefillChunk, Request, TokenBudgetPolicy,
                        VictimPolicy, YoungestFirst)

__all__ = ["RaggedCacheView", "RaggedLayerCache", "kv_cache_scatter",
           "kv_cache_scatter_quant", "ragged_attention", "ENV_KV_DTYPE",
           "ENV_WEIGHT_DTYPE", "GenerationEngine", "sample_next",
           "RequestRejected", "ServingError", "ServingStepTimeout",
           "ServingUnavailable", "PagedKVCache", "AdmissionPolicy",
           "ContinuousBatchingScheduler", "PrefillChunk", "Request",
           "TokenBudgetPolicy", "VictimPolicy", "YoungestFirst"]
