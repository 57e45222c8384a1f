"""Comparison helpers for rankings computed by two implementations.

Two exact selections over scores that agree only to a tolerance (another
device, another summation order) may order near-ties differently. The rule
here: a ranked position must hold the same index as the reference unless
the reference's score there is within the tolerance of a neighbour's, or
it is the last position (whose unseen successor may be that close).
"""
from __future__ import annotations

import numpy as np


def _per_row(tol, ndim: int):
    """A scalar, or one value per row broadcast along the ranked axis."""
    tol = np.asarray(tol, np.float64)
    return tol if tol.ndim == 0 else tol.reshape(tol.shape + (1,) * (ndim - tol.ndim))


def rank_mismatches(ref_idx, ref_scores, idx, atol=0.0, rtol=0.0) -> int:
    """Number of ranked positions (last axis) where ``idx`` differs from
    ``ref_idx`` although the reference score there is separated from both
    neighbours by more than ``atol + rtol * |score|``. ``atol`` and
    ``rtol`` are scalars or one value per row."""
    ref_idx, ref_scores, idx = (np.asarray(a) for a in (ref_idx, ref_scores, idx))
    s = ref_scores.astype(np.float64)
    bound = (_per_row(atol, s.ndim)
             + _per_row(rtol, s.ndim) * np.maximum(np.abs(s[..., 1:]), np.abs(s[..., :-1])))
    close = np.abs(np.diff(s, axis=-1)) <= bound
    exempt = np.zeros(ref_idx.shape, bool)
    exempt[..., 1:] |= close
    exempt[..., :-1] |= close
    exempt[..., -1] = True
    return int(((ref_idx != idx) & ~exempt).sum())


def within(ref, got, atol=0.0, rtol=0.0) -> bool:
    """|got - ref| <= atol + rtol * |ref| everywhere (per-row tolerances
    allowed, as in ``rank_mismatches``)."""
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return bool(np.all(np.abs(got - ref)
                       <= _per_row(atol, ref.ndim) + _per_row(rtol, ref.ndim) * np.abs(ref)))
