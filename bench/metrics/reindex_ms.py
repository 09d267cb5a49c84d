"""Router query index (``SwarmRouter.reindex_all_queries``, on the host,
after a plan change): the standing queries' cells and per-partition
counts are kept between calls, and a call counts only the partition ids
the round minted (a subset move's id takes its parent's rows, a split's
halves and a merge are tested one id at a time); every live id is
tested only after the query set or the partition table is replaced.
Host ms per call, the span the benchmark puts around the call."""


def read(trace):
    vals = [e.dur for e in trace.spans if e.name == "reindex_queries"]
    return sum(vals) / len(vals) / 1e6 if vals else None
