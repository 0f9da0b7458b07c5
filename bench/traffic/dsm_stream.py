"""DSM stream: structural changes (MOVE and MERGE, 1:1) at seeded Poisson
arrivals of a fixed rate. At its arrival each op is the next template that
applies to the harness's replayed tree (a source or target lost to an
earlier merge is skipped); it is applied to the replay and handed to the
scheduler's maintenance hook, which acknowledges it once ``dsm_batch``
has returned (journaled).

Parameters: ``ops_per_s``.
"""
from __future__ import annotations

import threading
import time

import numpy as np


class Stream:
    def __init__(self, ctx, params: dict, seed: int):
        self.ctx = ctx
        self.rate = float(params["ops_per_s"])
        self.rng = np.random.default_rng([int(seed), 5])
        self.thread = threading.Thread(target=self._run, name="dsm-stream",
                                       daemon=True)

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
            t += float(self.rng.exponential(1.0 / self.rate))
            if t >= self.t_end:
                return
            now = clock()
            if t > now:
                time.sleep(t - now)
            if not ctx.submit_dsm(t):
                return
