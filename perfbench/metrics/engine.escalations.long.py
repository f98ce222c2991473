"""engine.escalations.long: the engine's frame-budget escalations (a piece's
``infer`` made again at the next frame bucket) per paragraph over the
profiled stretch, from the program's counters ``serve.escalations`` and
``serve.requests`` (one a ``synthesize`` call, a paragraph here)."""

from perfbench import program


def read(ctx):
    counters = program.snapshot().get("counters", {})
    requests = counters.get("serve.requests")
    if not requests:
        return None
    return counters.get("serve.escalations", 0) / requests
