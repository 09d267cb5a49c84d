"""Engine per-tick path (``StreamingEngine.step``: arrivals, injection
through ``Router.ingest`` and the data plane's per-call pricing, the
tick's queue dynamics): host ms per call, span ``tick`` less the spans
nested in it that have layers of their own (``round_close`` and
``reindex_queries``)."""


def read(trace):
    ticks = {e.seq: e.dur for e in trace.spans if e.name == "tick"}
    if not ticks:
        return None
    total = sum(ticks.values())
    total -= sum(e.dur for e in trace.spans
                 if e.name in ("round_close", "reindex_queries")
                 and e.parent in ticks)
    return total / len(ticks) / 1e6
