"""mas_roofline: the MAS byte bound (``reference/peaks.py::mas_bound_s``) of
the profiled steps over the device time of the kernels launched inside the
benchmark's span around ``maximum_path``, in percent. It reads the same work
whichever kernel computes MAS."""


def read(ctx):
    span = ctx.get("trace", {}).get("spans", {}).get("mas")
    if not span or span["device_s"] <= 0:
        return None
    return 100.0 * ctx["mas_bound_s"] / span["device_s"]
