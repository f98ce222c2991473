"""engine.graph_hit_share.long: the share of the engine's budgeted
``model.infer`` calls replayed from a CUDA graph captured before them, 100 x
``serve.graph_replays`` / ``serve.infer_calls``, over the profiled stretch:
the program's counters, in percent. Nothing where the program counts no
graph (a program without the graph cache, or a device without graphs)."""

from perfbench import program


def read(ctx):
    counters = program.snapshot().get("counters", {})
    calls = counters.get("serve.infer_calls")
    if not calls or not ({"serve.graph_replays", "serve.graph_captures"} & set(counters)):
        return None
    return 100.0 * counters.get("serve.graph_replays", 0) / calls
