"""Closed loop: ``clients`` callers, each sending its next query only when
its previous answer has come back (an agent's retrieval tools awaiting
their results). Batches complete in admission order (one tenant, FIFO
batches, one executing thread), so the stream waits on the oldest
outstanding ticket and replaces every answered one at once.

Parameters: ``clients``.
"""
from __future__ import annotations

import threading
from collections import deque


class Stream:
    def __init__(self, ctx, params: dict, seed: int):
        self.ctx = ctx
        self.clients = int(params["clients"])
        self.thread = threading.Thread(target=self._run, name="closed-loop",
                                       daemon=True)
        self.t_end = None

    def start(self, t_end: float) -> None:
        self.t_end = t_end
        self.thread.start()

    def join(self, timeout: float) -> None:
        self.thread.join(timeout)

    def _run(self) -> None:
        ctx = self.ctx
        clock = ctx.clock
        out = deque(ctx.submit_dsq(clock()) for _ in range(self.clients))
        while out:
            head = out[0]
            head.wait(timeout=1.0)
            now = clock()
            while out and out[0].done():
                out.popleft()
                if now < self.t_end:
                    out.append(ctx.submit_dsq(now))
            if now >= self.t_end:
                return
