"""Beyond-paper integration: the learned page prefetcher applied to
host<->HBM KV-cache offload paging during serving (TPUs have no UVM; the
same far-fault economics appear when the KV cache overflows HBM)."""
from repro_torch.offload.paged_store import PagedKVStore
from repro_torch.offload.learned_prefetcher import OffloadPrefetcher

__all__ = ["PagedKVStore", "OffloadPrefetcher"]
