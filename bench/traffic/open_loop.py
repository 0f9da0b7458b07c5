"""Open loop: independent users' queries at seeded Poisson arrivals of a
fixed rate. Each request is submitted at its scheduled time, or at once if
the stream runs late, and carries its scheduled time, so a stall counts
against every request it delays.

Parameters: ``qps`` (null until a sweep has set it).
"""
from __future__ import annotations

import threading
import time

import numpy as np


class Stream:
    def __init__(self, ctx, params: dict, seed: int):
        self.ctx = ctx
        if params.get("qps") is None:
            raise ValueError("the cell's rate is not set: find it with "
                             "bench/sweep.py, one process per rate")
        self.qps = float(params["qps"])
        self.rng = np.random.default_rng([int(seed), 4])
        self.thread = threading.Thread(target=self._run, name="open-loop",
                                       daemon=True)
        self.late_s = []

    def start(self, t_end: float) -> None:
        self.t_end = t_end
        self.thread.start()

    def join(self, timeout: float) -> None:
        self.thread.join(timeout)

    def _run(self) -> None:
        ctx = self.ctx
        clock = ctx.clock
        t = clock()
        while True:
            t += float(self.rng.exponential(1.0 / self.qps))
            if t >= self.t_end:
                return
            now = clock()
            if t > now:
                time.sleep(t - now)
                now = clock()
            self.late_s.append(now - t)
            ctx.submit_dsq(t)
