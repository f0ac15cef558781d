"""The classification metrics the evaluation harness reports, in numpy
(counterparts of the sklearn functions ``analysis/tester.py`` calls:
``sklearn.utils.multiclass.unique_labels``, ``sklearn.metrics.
confusion_matrix`` and ``classification_report(output_dict=True)``).

The card's machine has no sklearn. These follow sklearn 1.9's arithmetic
step for step, so that the reports written from them equal sklearn's
float for float: the labels are the sorted union of the truth and the
predictions; per-class precision ``tp / predicted``, recall ``tp / true``
and F1 ``2 tp / (true + predicted)`` in float64, ``zero_division`` where
a denominator is 0; ``accuracy`` (the micro average, when the labels
cover both arrays), ``macro avg`` (``numpy.nanmean``) and ``weighted
avg`` (weighted by support); every entry a Python float, ``support``
included. A normalised confusion-matrix row of a class absent from the
truth is zeros, not NaN.
"""

from __future__ import annotations

import numpy as np

__all__ = ["unique_labels", "confusion_matrix", "classification_report"]

_HEADERS = ("precision", "recall", "f1-score", "support")


def unique_labels(*ys) -> np.ndarray:
    """The sorted union of the labels of ``ys``; strings and numbers
    mixed raise, as sklearn does."""
    if not ys:
        raise ValueError("No argument has been passed.")
    labels = set()
    for y in ys:
        labels.update(np.asarray(y).reshape(-1).tolist())
    if len({isinstance(v, str) for v in labels}) > 1:
        raise ValueError("Mix of label input types (string and number)")
    return np.asarray(sorted(labels))


def _counts(y_true, y_pred, labels):
    """Per label: true positives, predicted and true totals (int64)."""
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    if len(y_true) != len(y_pred):
        raise ValueError(f"Found input variables with inconsistent numbers "
                         f"of samples: [{len(y_true)}, {len(y_pred)}]")
    index = {v: i for i, v in enumerate(np.asarray(labels).tolist())}
    n = len(index)
    t = np.asarray([index.get(v, n) for v in y_true.tolist()], np.int64)
    p = np.asarray([index.get(v, n) for v in y_pred.tolist()], np.int64)
    tp = np.bincount(t[(t == p) & (t < n)], minlength=n)[:n]
    pred = np.bincount(p[p < n], minlength=n)[:n]
    true = np.bincount(t[t < n], minlength=n)[:n]
    return tp.astype(np.int64), pred.astype(np.int64), true.astype(np.int64)


def _divide(num, den, zero_division: float) -> np.ndarray:
    den = np.asarray(den, np.float64).copy()
    mask = den == 0
    den[mask] = 1.0
    out = np.asarray(num, np.float64) / den
    out[mask] = zero_division
    return out


def _prf(tp, pred, true, zero_division):
    precision = _divide(tp, pred, zero_division)
    recall = _divide(tp, true, zero_division)
    f1 = _divide(2.0 * tp.astype(np.float64),
                 1.0 * true.astype(np.float64) + pred.astype(np.float64),
                 zero_division)
    return precision, recall, f1


def _average(a: np.ndarray, weights=None) -> float:
    mask = np.isnan(a)
    if a.shape[0] == 0 or mask.all():
        return float("nan")
    if weights is None:
        return float(np.nanmean(a))
    a = a[~mask]
    w = np.asarray(weights)[~mask].astype(np.float64)
    if w.sum() == 0:
        return float(np.mean(a))
    return float(np.sum(a * w) / np.sum(w))


def confusion_matrix(y_true, y_pred, labels=None,
                     normalize: str | None = None) -> np.ndarray:
    """``[n_labels, n_labels]`` counts, rows the truth and columns the
    prediction, over ``labels`` (default: ``unique_labels``); samples of
    other labels are left out. ``normalize`` "true", "pred" or "all"
    divides by the rows, the columns or the total (0 where that is 0)."""
    labels = unique_labels(y_true, y_pred) if labels is None \
        else np.asarray(labels)
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    if len(y_true) and not np.isin(y_true, labels).any():
        raise ValueError("At least one label specified must be in y_true")
    index = {v: i for i, v in enumerate(labels.tolist())}
    n = len(index)
    cm = np.zeros((n, n), np.int64)
    for t, p in zip(y_true.tolist(), y_pred.tolist()):
        if t in index and p in index:
            cm[index[t], index[p]] += 1
    if normalize is None:
        return cm
    with np.errstate(all="ignore"):
        if normalize == "true":
            out = cm / cm.sum(axis=1, keepdims=True)
        elif normalize == "pred":
            out = cm / cm.sum(axis=0, keepdims=True)
        elif normalize == "all":
            out = cm / cm.sum()
        else:
            raise ValueError(f"normalize must be one of 'true', 'pred', "
                             f"'all' or None; got {normalize!r}")
    return np.nan_to_num(out)


def classification_report(y_true, y_pred, output_dict: bool = True,
                          zero_division: float = 0) -> dict:
    """sklearn's ``classification_report(y_true, y_pred,
    output_dict=True, zero_division=...)``: ``{label: {precision, recall,
    f1-score, support}, "accuracy": float, "macro avg": {...},
    "weighted avg": {...}}``, the labels as strings."""
    if not output_dict:
        raise NotImplementedError("only the dict form is ported")
    zero_division = float(zero_division)
    labels = unique_labels(y_true, y_pred)
    tp, pred, true = _counts(y_true, y_pred, labels)
    p, r, f1 = _prf(tp, pred, true, zero_division)
    report = {f"{label}": dict(zip(_HEADERS, (float(p[i]), float(r[i]),
                                              float(f1[i]),
                                              float(true[i]))))
              for i, label in enumerate(labels.tolist())}
    support = float(np.sum(true))
    micro = _prf(tp.sum(keepdims=True), pred.sum(keepdims=True),
                 true.sum(keepdims=True), zero_division)
    report["accuracy"] = float(micro[0][0])
    for name, weights in (("macro avg", None), ("weighted avg", true)):
        report[name] = dict(zip(_HEADERS, (
            _average(p, weights), _average(r, weights),
            _average(f1, weights), support)))
    return report
