"""Row-sharded scoped search over a shard mesh (``search.py``)."""
from .search import (make_multi_scope_search, make_scoped_search,
                     make_sharded_batch_search, make_sharded_batch_search_i8,
                     make_sharded_batch_search_pq, merge_local_topk,
                     multi_scope_search_input_specs, search_input_specs,
                     shard_rows, shard_words)

__all__ = ["merge_local_topk", "shard_rows", "shard_words",
           "make_scoped_search", "make_multi_scope_search",
           "make_sharded_batch_search", "make_sharded_batch_search_i8",
           "make_sharded_batch_search_pq", "search_input_specs",
           "multi_scope_search_input_specs"]
