"""disc.share.ljs_train: the discriminator's forward share of the traced
steps' device time: 100 x the device seconds of the kernels launched inside
the benchmark's span ``disc`` (the discriminator's ``forward``, in the D step
and in the G step) over the busy device seconds of the profiled stretch, in
percent. Nothing without the span (a program without the pitchless step)."""


def read(ctx):
    trace = ctx.get("trace") or {}
    span = trace.get("spans", {}).get("disc")
    if not span or not trace.get("busy_s"):
        return None
    return 100.0 * span["device_s"] / trace["busy_s"]
