"""Where the enqueue runtime's cycle thread spends its time: a sampling
profile of that thread alone.

``CycleProfile`` starts a sampler thread that, every ``interval`` seconds,
reads the cycle thread's stack (``sys._current_frames``) and, when
``run_cycle`` is on it (the thread is in a cycle, not waiting for work),
adds the time since the last sample to every function on the stack
(cumulative) and to the innermost one (own). A blocked call (a lock, the
interpreter lock, a CUDA or NCCL call) counts for the Python function that
made it: this is the thread's wall time, which is what holds a step back.
Python 3.12's ``cProfile`` cannot single out one thread (it is built on
``sys.monitoring``, which reports every thread's calls at once), hence the
sampler.

It imports nothing of the package, so the before/after tools load it by
path and profile another checkout's runtime as well as this one's
(``tools/runtime_before_after.py --profile-cycle``,
``tools/adamw_before_after.py --steps --profile-cycle``).
"""

from __future__ import annotations

import collections
import sys
import threading
import time

THREAD = "hvd-background-loop"  # the runtime's cycle thread


class CycleProfile:
    def __init__(self, interval: float = 0.0005):
        self.interval = interval
        self.cum: "collections.Counter" = collections.Counter()
        self.own: "collections.Counter" = collections.Counter()
        self.seconds = 0.0  # in cycles
        self.samples = 0
        self._stop = threading.Event()
        self._thread = None
        self._tid = None

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="hvd-cycle-sampler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _cycle_thread(self, frames: dict):
        if self._tid not in frames:
            self._tid = next((t.ident for t in threading.enumerate()
                              if t.name == THREAD), None)
        return frames.get(self._tid)

    def _run(self) -> None:
        last = time.perf_counter()
        while not self._stop.wait(self.interval):
            now = time.perf_counter()
            dt, last = now - last, now
            frame = self._cycle_thread(sys._current_frames())
            stack = []
            while frame is not None:
                code = frame.f_code
                where = "/".join(code.co_filename.split("/")[-2:])
                stack.append(f"{where}:{code.co_firstlineno} {code.co_name}")
                frame = frame.f_back
            if not any(s.endswith(" run_cycle") for s in stack):
                continue
            stack = [s for s in stack if "/threading.py:" not in s]
            self.seconds += dt
            self.samples += 1
            self.own[stack[0]] += dt
            for key in set(stack):
                self.cum[key] += dt

    def top(self, n: int = 15, steps: int = 1) -> dict:
        """The ``n`` functions with the most cumulative time, each with its
        cumulative and own ms a step; and the ms a step in cycles."""
        per = 1e3 / max(steps, 1)
        return {"cycle_ms_per_step": self.seconds * per,
                "samples": self.samples,
                "top": [{"function": key, "cum_ms": cum * per,
                         "own_ms": self.own.get(key, 0.0) * per}
                        for key, cum in self.cum.most_common(n)]}
