"""LLM serving: paged KV cache, ragged attention, continuous batching,
multi-LoRA tenancy."""
from .attention import (PagedCacheView, PagedLayerCache, RaggedCacheView,
                        RaggedLayerCache, kv_cache_scatter,
                        kv_cache_scatter_quant, paged_attention,
                        ragged_attention)
from .engine import (ENV_KV_DTYPE, ENV_WEIGHT_DTYPE, GenerationEngine,
                     sample_next)
from .errors import (RequestRejected, ServingError, ServingStepTimeout,
                     ServingUnavailable)
from .kv_cache import PagedKVCache
from .lora import (AdapterStoreFull, LoRAAdapterStore, SegmentAdapterState,
                   attach_lora_sites, convert_to_lora, load_lora_state_dict,
                   lora_state_dict, merge_lora, unmerge_lora)
from .scheduler import (AdmissionPolicy, ContinuousBatchingScheduler,
                        PrefillChunk, Request, TokenBudgetPolicy,
                        VictimPolicy, YoungestFirst)

__all__ = ["PagedCacheView", "PagedLayerCache", "RaggedCacheView",
           "RaggedLayerCache", "kv_cache_scatter", "kv_cache_scatter_quant",
           "paged_attention", "ragged_attention", "AdapterStoreFull",
           "LoRAAdapterStore", "SegmentAdapterState", "attach_lora_sites",
           "convert_to_lora", "load_lora_state_dict", "lora_state_dict",
           "merge_lora", "unmerge_lora", "ENV_KV_DTYPE",
           "ENV_WEIGHT_DTYPE", "GenerationEngine", "sample_next",
           "RequestRejected", "ServingError", "ServingStepTimeout",
           "ServingUnavailable", "PagedKVCache", "AdmissionPolicy",
           "ContinuousBatchingScheduler", "PrefillChunk", "Request",
           "TokenBudgetPolicy", "VictimPolicy", "YoungestFirst"]
