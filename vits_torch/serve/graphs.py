"""CUDA graphs of the engine's budgeted ``SynthesizerTrn.infer``.

A budgeted call runs at a static shape (rows padded to a batch bucket, text
to a text bucket, frames to a frame budget) and reads no host value, so the
whole call is a fixed chain of a few thousand small launches; at batch 1
the host's dispatch of them, not the device, sets its pace. ``InferGraphs``
captures the call once per key (rows, text bucket, frame budget, and the
noise scales and speaker-or-not the capture bakes in) and replays it after.

- First call at a key: the call's values go into static input buffers, one
  eager warm-up runs on a side stream, ``infer`` is captured into a
  ``torch.cuda.CUDAGraph`` (``capture_error_mode="thread_local"``, so other
  serving threads may go on working) and the graph is replayed.
- Later calls: the values are copied into the buffers (``copy_``), the
  graph is replayed, and the outputs are copied out of the graph's static
  outputs.

The per-row controls (``length_scale``, ``scope_shift``) are [rows] tensor
inputs, never baked in: one graph serves every duration and shift (a call
that gives them as numbers runs eagerly). The replay runs the kernels the
eager call runs, in its order, so its audio is the eager audio, bit for bit.

Invariants:

- One lock covers copy-in, replay and read-out, and the capture. Graphs share
  one memory pool, so a replay may overwrite another graph's outputs: each
  replay's outputs are copied out before the lock is let go, that is before
  any other replay. A replay on another stream than the last read-out's
  waits for it first.
- Weights are read where they live: a change made in place
  (``load_state_dict``, ``Tensor.copy_``) is seen by the next replay; one
  that replaces a parameter's storage (``.to()``, ``assign=True``) is not.

Counters (``utils/profiling.py``): ``serve.graph_captures`` (keys captured)
and ``serve.graph_replays`` (calls served by a graph captured before them).
"""

from __future__ import annotations

import threading

import torch

from vits_torch.utils.profiling import count

NOISE = ("sdp_noise", "eps")


class InferGraphs:
    """The graph cache a model's ``infer`` replays from (see the module
    docstring); ``model.infer_graphs = InferGraphs()`` turns it on."""

    def __init__(self):
        self._lock = threading.Lock()
        self._graphs: dict[tuple, tuple] = {}  # key -> (graph, inputs, outputs)
        self._pool = None
        self._done = None  # recorded after each read-out

    @staticmethod
    def takes(x, noise, generator, length_scale, scope_shift) -> bool:
        """A call the cache can serve: on a CUDA device, with every draw
        given and the controls as tensors, under ``torch.inference_mode()``."""
        return (x.is_cuda and generator is None and noise is not None
                and all(k in noise for k in NOISE)
                and isinstance(length_scale, torch.Tensor) and isinstance(scope_shift, torch.Tensor)
                and torch.is_inference_mode_enabled())

    def __call__(self, infer, x, t, x_lengths, sid, noise, length_scale, scope_shift, **baked):
        """``infer`` (the eager call) at the call's key, replayed; ``baked``
        are the keywords the capture holds fixed (``max_frames`` and the
        noise scales)."""
        key = (tuple(x.shape), sid is None, tuple(sorted(baked.items())))
        values = {"x": x, "t": t, "x_lengths": x_lengths, "sid": sid,
                  "sdp_noise": noise["sdp_noise"], "eps": noise["eps"],
                  "length_scale": length_scale, "scope_shift": scope_shift}
        with self._lock:
            stream = torch.cuda.current_stream(x.device)
            if self._done is None:
                self._done = torch.cuda.Event()
            else:
                stream.wait_event(self._done)
            if key in self._graphs:
                graph, inputs, outputs = self._graphs[key]
                for name, buf in inputs.items():
                    buf.copy_(values[name])
                count("serve.graph_replays")
            else:  # the capture loads the buffers itself
                graph, _, outputs = self._graphs[key] = self._capture(infer, values, baked)
                count("serve.graph_captures")
            graph.replay()
            out = tuple(o.clone() for o in outputs)
            self._done.record(stream)
            return out

    def _capture(self, infer, values: dict, baked: dict) -> tuple:
        x = values["x"]
        inputs = {name: torch.empty_like(v, device=x.device).copy_(v)
                  for name, v in values.items() if v is not None}

        def run():
            return infer(
                inputs["x"], inputs["t"], inputs["x_lengths"], inputs.get("sid"),
                noise={k: inputs[k] for k in NOISE}, length_scale=inputs["length_scale"],
                scope_shift=inputs["scope_shift"], **baked,
            )

        # warm-up: lazy initialisation (cuDNN, cuBLAS) stays out of the capture
        side = torch.cuda.Stream(x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream(x.device).wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
            outputs = run()
        return graph, inputs, tuple(outputs)
