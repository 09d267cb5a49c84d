"""Router query index (``SwarmRouter.reindex_all_queries``: after a plan
change, every standing query overlapped against every live partition
again, on the host): host ms per call, the span the benchmark puts
around the call."""


def read(trace):
    vals = [e.dur for e in trace.spans if e.name == "reindex_queries"]
    return sum(vals) / len(vals) / 1e6 if vals else None
