"""The port's classification metrics (``analysis/metrics.py``) against
sklearn on seeded label sets: string and integer labels, classes that
only the predictions hold, a class with no support, one class. The
reports must equal sklearn's float for float (the JSON files the Tester
writes are compared as they are), the confusion matrices exactly."""

import json

import numpy as np
import pytest
from sklearn.metrics import classification_report as sk_report
from sklearn.metrics import confusion_matrix as sk_confusion
from sklearn.utils.multiclass import unique_labels as sk_unique

from craniofacialsd_vae_tpu_torch.analysis.metrics import (
    classification_report, confusion_matrix, unique_labels)


def _labels(case: str, seed: int):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 40))
    if case == "strings":
        pool = np.array(["n", "a", "c", "m"])
        return pool[rng.integers(0, 4, n)], pool[rng.integers(0, 4, n)]
    if case == "pred_only":          # 'm' only among the predictions
        t = np.array(["n", "a", "c"])[rng.integers(0, 3, n)]
        p = np.array(["n", "a", "c", "m"])[rng.integers(0, 4, n)]
        p[0] = "m"
        return t, p
    if case == "no_support":          # class 2 predicted, never true
        t = rng.integers(0, 2, n)
        p = rng.integers(0, 3, n)
        p[-1] = 2
        return t, p
    if case == "ints":
        return rng.integers(0, 5, n), rng.integers(0, 5, n)
    if case == "one_class":
        return np.array(["n"] * n), np.array(["n"] * n)
    if case == "perfect":
        t = np.array(["a", "c", "n"])[rng.integers(0, 3, n)]
        return t, t.copy()
    raise ValueError(case)


CASES = [(c, s) for c in ("strings", "pred_only", "no_support", "ints")
         for s in range(4)] + [("one_class", 0), ("perfect", 1)]


@pytest.mark.parametrize("case,seed", CASES)
def test_classification_report_equals_sklearn(case, seed):
    t, p = _labels(case, seed)
    got = classification_report(t, p, output_dict=True, zero_division=0)
    want = sk_report(t, p, output_dict=True, zero_division=0)
    assert got == want
    assert list(got) == list(want)                    # the key order too
    assert json.dumps(got) == json.dumps(want)


@pytest.mark.parametrize("case,seed", CASES)
@pytest.mark.parametrize("normalize", [None, "true", "pred", "all"])
def test_confusion_matrix_equals_sklearn(case, seed, normalize):
    t, p = _labels(case, seed)
    labels = sk_unique(t, p)
    np.testing.assert_array_equal(unique_labels(t, p), labels)
    got = confusion_matrix(t, p, labels=labels, normalize=normalize)
    want = sk_confusion(t, p, labels=labels, normalize=normalize)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert not np.isnan(got).any()


def test_confusion_matrix_rows_of_absent_classes_are_zero():
    """A class only the predictions hold gives a normalised row of zeros
    (sklearn's nan_to_num), and labels narrower than the data drop the
    other samples."""
    t = np.array(["n", "n", "a"])
    p = np.array(["n", "c", "a"])
    cm = confusion_matrix(t, p, labels=unique_labels(t, p), normalize="true")
    np.testing.assert_array_equal(cm[1], [0.0, 0.0, 0.0])     # 'c'
    np.testing.assert_array_equal(
        confusion_matrix(t, p, labels=["a", "n"]),
        sk_confusion(t, p, labels=["a", "n"]))


def test_mixed_label_types_raise():
    with pytest.raises(ValueError, match="Mix of label input types"):
        unique_labels(["a", "b"], [1, 2])
    with pytest.raises(ValueError):
        sk_unique(["a", "b"], [1, 2])
