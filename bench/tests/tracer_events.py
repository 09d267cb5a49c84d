"""Hand-made tracer span events for the reader tests."""
from types import SimpleNamespace


def span(seq, name, t0, dur, parent=-1, **args):
    return SimpleNamespace(kind="span", name=name, seq=seq, parent=parent,
                           t0=int(t0), dur=int(dur), args=args, tick=0)
