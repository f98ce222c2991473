"""Dynamic request batching for serving (port of ``vits_tpu/serve/batcher.py``).

DynamicBatcher queues concurrent requests and flushes them through
``TTSEngine.synthesize_batch``, whose rows draw their noise from one
generator each, so a request's audio does not depend on what it was batched
with. One worker thread drives the engine (and the card); callers only
enqueue and wait on futures.

Flush policy: a batch goes out when either `max_batch` requests are
waiting or the oldest waiting request has aged `max_wait_ms`. Grouping by
(text-bucket, frame-bucket) happens inside synthesize_batch; the batcher
only decides WHEN to flush, keeping the policy in one place.

Usage:
    batcher = DynamicBatcher(engine, max_batch=8, max_wait_ms=5.0)
    fut = batcher.submit("[EN]hello world[EN]", speaker_id=3)
    sr, audio = fut.result()
    ...
    batcher.close()
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future


class DynamicBatcher:
    def __init__(self, engine, max_batch: int = 8, max_wait_ms: float = 5.0):
        self.engine = engine
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: list[tuple[dict, Future]] = []
        self._closed = False
        self._worker = threading.Thread(
            target=self._run, name="tts-batcher", daemon=True
        )
        self._worker.start()

    def submit(
        self,
        text: str,
        speaker_id: int = 0,
        seed: int = 0,
        scope_shift: int = 0,
        duration: float = 1.0,
    ) -> Future:
        """Enqueue one request; resolves to (sampling_rate, waveform)."""
        req = dict(
            text=text, speaker_id=speaker_id, seed=seed,
            scope_shift=scope_shift, duration=duration,
        )
        fut: Future = Future()
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._queue.append((req, fut))
            self._cv.notify()
        return fut

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if self._closed and not self._queue:
                    return
                # age-or-size flush: wait (bounded) for the batch to fill
                deadline = time.monotonic() + self.max_wait_s
                while (
                    len(self._queue) < self.max_batch
                    and not self._closed
                    and time.monotonic() < deadline
                ):
                    self._cv.wait(timeout=deadline - time.monotonic())
                batch = self._queue[: self.max_batch]
                del self._queue[: self.max_batch]
            reqs = [r for r, _ in batch]
            try:
                audios = self.engine.synthesize_batch(reqs)
                for (_, fut), audio in zip(batch, audios):
                    if isinstance(audio, Exception):
                        fut.set_exception(audio)  # that request alone failed
                    else:
                        fut.set_result((self.engine.sampling_rate, audio))
            except Exception as e:  # whole-batch failure: every caller sees it
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)

    def close(self) -> None:
        """Drain the queue and stop the worker."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._worker.join()
