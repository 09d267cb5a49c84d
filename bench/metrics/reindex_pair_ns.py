"""Router query index (``SwarmRouter.reindex_all_queries``): host ns per
query × partition pair tested, over the window's re-indexes: Σ duration
of span ``query_reindex`` over Σ its ``pairs`` arg (standing queries ×
the partition ids the call tested: those the round minted, not every
live one).  The per-call time grows with the ids a round mints; the
rate per pair does not."""


def read(trace):
    calls = [e for e in trace.spans if e.name == "query_reindex"]
    pairs = sum(e.args.get("pairs", 0) for e in calls)
    if not pairs:
        return None
    return sum(e.dur for e in calls) / pairs
