"""Router query index, keyword routers (``reindex_all_queries``'s pivot
histogram: a ``np.bincount`` of each tested partition id's hits by
their pivot term): host ms per re-index, Σ span ``reindex_pivots``
over the count of span ``query_reindex``."""


def read(trace):
    pivots = [e.dur for e in trace.spans if e.name == "reindex_pivots"]
    calls = sum(e.name == "query_reindex" for e in trace.spans)
    if not pivots or not calls:
        return None
    return sum(pivots) / calls / 1e6
