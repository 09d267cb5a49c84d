"""Multi-model query subsystem: query-execution models (continuous
range, continuous kNN, snapshot range, spatial-keyword pub/sub) and
data-persistence models (ephemeral, stored) consumed by the streaming
engine, the routers and the SWARM protocol.  See models.py for the
plug-in contract, keywords.py for the hashed term dimension and
store.py for the resident-data state.
"""
from .keywords import (SubscriptionIndex, TermHasher, bucket_masks,
                       bucket_onehot, tokenize)
from .models import (PersistenceModel, QueryModel, QueryModelSpec,
                     WorkloadSpec, all_workloads, get_query_model,
                     register_query_model)
from .store import TupleStore

__all__ = [
    "QueryModel", "PersistenceModel", "QueryModelSpec", "WorkloadSpec",
    "all_workloads", "get_query_model", "register_query_model", "TupleStore",
    "TermHasher", "SubscriptionIndex", "bucket_masks", "bucket_onehot",
    "tokenize",
]
