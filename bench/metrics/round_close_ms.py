"""Control plane (``Swarm.run_round``: the statistics close on K1, the
cost reports, the decision, the planner and the plan's application):
host ms per SWARM round, span ``round_close``."""


def read(trace):
    vals = [e.dur for e in trace.spans if e.name == "round_close"]
    return sum(vals) / len(vals) / 1e6 if vals else None
