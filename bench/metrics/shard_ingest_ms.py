"""Sharded data plane window, its ingest: host ms per sharded window in
span ``shard_ingest`` (each shard's chunk of the staged batches uploaded
and binned onto the cell grid on its own card), Σ over the count of
``sharded_window_dispatch`` spans.  ``None`` where the plane opens no
``shard_ingest``."""


def read(trace):
    windows = sum(e.name == "sharded_window_dispatch" for e in trace.spans)
    ingest = [e.dur for e in trace.spans if e.name == "shard_ingest"]
    return sum(ingest) / windows / 1e6 if windows and ingest else None
