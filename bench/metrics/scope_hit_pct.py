"""Scope-mask cache hits over lookups inside the window, in percent
(``ScopeMaskCache.stats()``; staging and planning both look up)."""


def read(run, entry):
    d = run.cache_delta
    total = d["hits"] + d["misses"]
    return 100.0 * d["hits"] / total if total else None
