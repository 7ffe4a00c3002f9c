"""Forecast accuracy metrics, masked and batched (host numpy).

sMAPE is the parity metric of the fit (the JAX package's eval and the
scipy oracle use it); the rest are its standard companions.  Every
function takes (..., T) arrays (numpy, or tensors, which are copied to
the host) plus an optional validity mask and reduces over the trailing
time axis.
"""

from __future__ import annotations

import numpy as np


def _np(a):
    if a is None:
        return None
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def _masked(err, mask):
    if mask is None:
        return err, err.shape[-1]
    return err * mask, np.maximum(mask.sum(axis=-1), 1.0)


def smape(y_true, y_pred, mask=None, eps: float = 1e-9):
    """Symmetric MAPE in percent: 200/n * sum |y-yhat| / (|y|+|yhat|)."""
    y_true, y_pred, mask = _np(y_true), _np(y_pred), _np(mask)
    denom = np.abs(y_true) + np.abs(y_pred) + eps
    err, n = _masked(np.abs(y_true - y_pred) / denom, mask)
    return 200.0 * err.sum(axis=-1) / n


def mae(y_true, y_pred, mask=None):
    y_true, y_pred, mask = _np(y_true), _np(y_pred), _np(mask)
    err, n = _masked(np.abs(y_true - y_pred), mask)
    return err.sum(axis=-1) / n


def rmse(y_true, y_pred, mask=None):
    y_true, y_pred, mask = _np(y_true), _np(y_pred), _np(mask)
    err, n = _masked((y_true - y_pred) ** 2, mask)
    return np.sqrt(err.sum(axis=-1) / n)


def coverage(y_true, lower, upper, mask=None):
    """Fraction of observations inside [lower, upper]."""
    y_true, lower, upper, mask = _np(y_true), _np(lower), _np(upper), \
        _np(mask)
    inside = ((y_true >= lower) & (y_true <= upper)).astype(lower.dtype)
    err, n = _masked(inside, mask)
    return err.sum(axis=-1) / n
