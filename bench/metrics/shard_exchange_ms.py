"""Sharded data plane window, its owner-keyed exchange: host ms per
sharded window in spans ``shard_exchange`` (one a destination card: the
columns of the cells it owns gathered on every source card and summed
on its own), Σ over the count of ``sharded_window_dispatch`` spans.
``None`` where the plane opens no ``shard_exchange``."""


def read(trace):
    windows = sum(e.name == "sharded_window_dispatch" for e in trace.spans)
    exchange = [e.dur for e in trace.spans if e.name == "shard_exchange"]
    return sum(exchange) / windows / 1e6 if windows and exchange else None
