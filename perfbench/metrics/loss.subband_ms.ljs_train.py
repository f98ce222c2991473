"""loss.subband_ms.ljs_train: the sub-band STFT loss's device time a traced
step: the device seconds of the kernels launched inside the benchmark's span
``subband_loss`` (the loss and the real segment's PQMF analysis) over the
profiled steps, in milliseconds. Nothing without the span."""


def read(ctx):
    span = (ctx.get("trace") or {}).get("spans", {}).get("subband_loss")
    if not span or not ctx.get("traced_steps"):
        return None
    return 1e3 * span["device_s"] / ctx["traced_steps"]
