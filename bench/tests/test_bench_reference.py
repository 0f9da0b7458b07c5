"""The plain reference against numpy brute force: scopes by path prefix,
DSM replay, exact ranking and the int8 plan."""
import numpy as np
import torch

from bench import reference


def _tree():
    paths = ["/", "/a/", "/a/b/", "/a/b/c/", "/a/d/", "/e/", "/e/b/",
             "/e/b/x/", "/f/"]
    return paths


def _brute(paths, anchor, rec):
    return sorted(i for i, p in enumerate(paths)
                  if (p.startswith(anchor) if rec else p == anchor))


def test_scope_spans_match_prefix_brute_force():
    paths = _tree()
    st = reference.DirState(paths, np.ones(len(paths)))
    for anchor in paths + ["/zz/", "/a/b/c/d/"]:
        for rec in (True, False):
            got = sorted(st.dirs_in([st.span(anchor, rec)]).tolist())
            assert got == _brute(paths, anchor, rec)
    assert st.rows_in([st.span("/a/"), st.span("/a/b/")]) == 4


def _replay(paths, ops):
    """Brute force: rewrite every directory's path string."""
    cur = list(paths)
    for kind, src, dst in ops:
        name = src[src.rstrip("/").rindex("/") + 1:]
        new = dst + name if kind == "move" else dst
        cur = [new + p[len(src):] if p.startswith(src) else p for p in cur]
    return cur


def test_dsm_replay_matches_rewriting_every_path():
    paths = _tree()
    st = reference.DirState(paths, np.ones(len(paths)))
    ops = [("move", "/a/b/", "/f/"), ("merge", "/e/", "/f/"),
           ("move", "/a/d/", "/f/b/")]
    assert not st.valid("move", "/a/b/", "/a/")       # b already under a
    assert not st.valid("move", "/a/b/", "/e/")       # /e/b/ exists
    applied = []
    for op in ops:
        if st.valid(*op):
            st.apply(*op)
            applied.append(op)
    assert applied == ops
    want = _replay(paths, ops)
    for anchor in set(want) | {"/e/", "/a/"}:
        got = sorted(st.dirs_in([st.span(anchor, True)]).tolist())
        assert got == _brute(want, anchor, True), anchor
    assert not st.valid("move", "/e/", "/a/")          # /e/ is gone


def _ranker_case(plan, window):
    rng = np.random.default_rng(3)
    rows = rng.normal(size=(500, 24)).astype(np.float32)
    entry_dir = rng.integers(0, 6, 500)
    q = rng.normal(size=(5, 24)).astype(np.float32)
    masks = rng.random((5, 6)) < 0.5
    masks[0] = False
    r = reference.Ranker(torch, rows, entry_dir, torch.device("cpu"), plan,
                         window)
    ids, scores = r.topk(q, masks, 7)
    return rows, entry_dir, q, masks, ids, scores, r


def test_exact_ranking_matches_numpy():
    rows, entry_dir, q, masks, ids, scores, r = _ranker_case("fp32", 7)
    assert (ids[0] == -1).all()
    for b in range(1, 5):
        adm = np.flatnonzero(masks[b][entry_dir])
        s = rows[adm].astype(np.float64) @ q[b].astype(np.float64)
        want = adm[np.argsort(-s, kind="stable")[:7]]
        assert set(ids[b].tolist()) == set(want.tolist())
    assert np.allclose(r.scores_of(q, ids)[1:], scores[1:], atol=1e-5)


def test_int8_plan_matches_numpy_emulation():
    rows, entry_dir, q, masks, ids, scores, _ = _ranker_case("int8", 20)

    def quant(x):
        amax = np.abs(x).max(1)
        sc = np.where(amax > 0, amax / np.float32(127), 1).astype(np.float32)
        return np.clip(np.rint(x / sc[:, None]), -127, 127), sc
    xc, xs = quant(rows)
    qc, qs = quant(q)
    for b in range(1, 5):
        adm = np.flatnonzero(masks[b][entry_dir])
        s8 = (xc[adm] @ qc[b]).astype(np.float32) * (qs[b] * xs[adm])
        cand = adm[np.argsort(-s8, kind="stable")[:20]]
        exact = rows[cand].astype(np.float64) @ q[b].astype(np.float64)
        want = cand[np.argsort(-exact, kind="stable")[:7]]
        assert set(ids[b].tolist()) == set(want.tolist())
