"""engine.rows_per_call.long: the real rows the engine's budgeted
``model.infer`` calls carry on average, ``serve.rows`` / ``serve.infer_calls``
over the profiled stretch: the program's counters. Nothing where the
program counts no rows (a program that runs every piece at batch 1 and
keeps no such counter)."""

from perfbench import program


def read(ctx):
    counters = program.snapshot().get("counters", {})
    calls = counters.get("serve.infer_calls")
    if not calls or "serve.rows" not in counters:
        return None
    return counters["serve.rows"] / calls
