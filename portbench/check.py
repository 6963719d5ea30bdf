"""The comparison that decides ``correct``.

Every kept answer (a seeded share of the window's requests, all of them in the
gateway cell) is compared row by row with the plain reference over the same
ring rows: its uint32 scores and its prediction.  The scores are exact
integers, so the comparison is exact and its limit is 0.  A request that
raised, was refused or never came back is ``requests_failed``; an answer with
the wrong shape counts all its rows wrong.
"""
from __future__ import annotations

import numpy as np

LIMITS = {"rows_wrong": 0, "requests_failed": 0}
LEAST = {"rows_checked": 1}


def compare(answers: list, ref_scores: np.ndarray, ref_preds: np.ndarray,
            failed: int) -> dict:
    wrong = checked = 0
    for start, n, scores, preds in answers:
        want_s, want_p = ref_scores[start:start + n], ref_preds[start:start + n]
        scores, preds = np.asarray(scores), np.asarray(preds)
        checked += n
        if scores.shape != want_s.shape or preds.shape != want_p.shape:
            wrong += n
            continue
        wrong += int(np.count_nonzero(np.any(scores != want_s, axis=1) | (preds != want_p)))
    return {"rows_wrong": wrong, "requests_failed": failed, "rows_checked": checked}


def verdict(numbers: dict) -> tuple:
    """(correct, {name: {"value", "limit"} or {"value", "least"}})."""
    out, ok = {}, True
    for name, limit in LIMITS.items():
        out[name] = {"value": numbers[name], "limit": limit}
        ok &= numbers[name] <= limit
    for name, least in LEAST.items():
        out[name] = {"value": numbers[name], "least": least}
        ok &= numbers[name] >= least
    return bool(ok), out
