"""engine.device_ms.ljs: device ms a paragraph in the engine's budgeted
``model.infer`` calls, replayed from its CUDA graphs: the device seconds of
the kernels launched inside the span ``infer`` over the profiled paragraphs
with the graphs, over their number. Nothing without that stretch."""


def read(ctx):
    spans = (ctx.get("trace") or {}).get("spans", {})
    n = ctx.get("traced_requests")
    if "infer" not in spans or not n:
        return None
    return 1e3 * spans["infer"]["device_s"] / n
