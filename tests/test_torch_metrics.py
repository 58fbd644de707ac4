"""gnn_tpu_torch.metrics (numpy) against gnn_tpu.metrics (scikit-learn) on the
same seeded labels and scores: every registry name at its defaults and with
the keyword arguments an engine user passes (extra_metrics_arguments), the
errors scikit-learn raises, zero division, and the ROC / precision-recall
curves and areas, per class and micro/macro. Registry values within 1e-15,
curves and average precision equal, ROC areas within 1e-12."""

import sys
import warnings

import numpy as np
import pytest
from sklearn import metrics as skm

from gnn_tpu import metrics as jmt
from gnn_tpu_torch import metrics as tmt

warnings.filterwarnings("ignore")


def _labels(kind, seed=0, n=60):
    rng = np.random.default_rng(seed)
    if kind == "binary":
        return rng.integers(0, 2, n), rng.integers(0, 2, n)
    if kind == "multiclass":
        return rng.integers(0, 4, n), rng.integers(0, 4, n)
    if kind == "one_class":               # y_pred never positive: zero division
        return rng.integers(0, 2, n), np.zeros(n, dtype=int)
    if kind == "all_zero":                # one label only
        return np.zeros(n, dtype=int), np.zeros(n, dtype=int)
    if kind == "pred_extra":              # a class only in y_pred
        return rng.integers(0, 2, n), rng.integers(0, 3, n)
    raise ValueError(kind)


def _call(fn, yt, yp, kw):
    try:
        return fn(yt, yp, **kw)
    except ValueError:
        return ("ValueError",)


def _same(got, want, atol=0.0):
    if isinstance(want, tuple):
        assert got == want
        return
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=atol, equal_nan=True)


KINDS = ("binary", "multiclass", "one_class", "all_zero", "pred_extra")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", sorted(jmt.Metrics))
def test_registry_defaults_match_sklearn(name, kind):
    yt, yp = _labels(kind)
    assert sorted(tmt.Metrics) == sorted(jmt.Metrics)
    _same(_call(tmt.Metrics[name], yt, yp, {}), _call(jmt.Metrics[name], yt, yp, {}), 1e-15)


ARGS = {
    "Acc": [{"normalize": False}, {"sample_weight": np.linspace(0.5, 2.0, 60)}],
    "Bacc": [{"adjusted": True}, {"sample_weight": np.linspace(0.5, 2.0, 60)}],
    "Ck": [{"weights": "linear"}, {"weights": "quadratic"}, {"labels": [0, 1]}],
    "Cl0": [{"class_label": 0}],
    "Cl1": [{"class_label": 1}],
    **{k: [{"average": a} for a in ("micro", "macro", "weighted", None)]
       + [{"pos_label": 0}, {"zero_division": 1}, {"zero_division": np.nan},
          {"average": "macro", "labels": [0, 1, 2]},
          {"sample_weight": np.linspace(0.5, 2.0, 60)}]
       for k in ("Prec", "Rec", "Fs", "Js")},
}


@pytest.mark.parametrize("kind", ("binary", "multiclass", "one_class", "pred_extra"))
@pytest.mark.parametrize("name,kw", [(n, kw) for n, kws in ARGS.items() for kw in kws],
                         ids=lambda v: v if isinstance(v, str) else
                         "-".join(f"{k}={v if not hasattr(v, 'shape') else 'w'}"
                                  for k, v in v.items()))
def test_registry_arguments_match_sklearn(name, kw, kind):
    yt, yp = _labels(kind, seed=1)
    _same(_call(tmt.Metrics[name], yt, yp, kw), _call(jmt.Metrics[name], yt, yp, kw), 1e-15)


def test_multiclass_under_binary_average_raises_sklearns_error():
    yt, yp = _labels("multiclass")
    with pytest.raises(ValueError) as want:
        jmt.Metrics["Fs"](yt, yp)
    with pytest.raises(ValueError) as got:
        tmt.Metrics["Fs"](yt, yp)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        tmt.Metrics["Acc"](yt, np.linspace(0.1, 0.9, len(yt)))   # continuous labels


@pytest.mark.parametrize("kind", ("binary", "pred_extra", "one_class"))
def test_confusion_matrix_and_rates(kind):
    yt, yp = _labels(kind, seed=2)
    np.testing.assert_array_equal(tmt.confusion_matrix(yt, yp), skm.confusion_matrix(yt, yp))
    np.testing.assert_array_equal(tmt.confusion_matrix(yt, yp, labels=[1, 0]),
                                  skm.confusion_matrix(yt, yp, labels=[1, 0]))
    for name in ("TPR", "TNR", "FPR", "FNR"):
        _same(_call(getattr(tmt, name), yt, yp, {}), _call(getattr(jmt, name), yt, yp, {}),
              1e-15)


def _scores(seed, n=80, c=3, ties=True):
    rng = np.random.default_rng(seed)
    y = np.eye(c)[rng.integers(0, c, n)]
    s = rng.random((n, c))
    if ties:
        s[::7] = np.round(s[::7], 1)        # tied scores
    return y, s


@pytest.mark.parametrize("pos_label", (0, 1))
@pytest.mark.parametrize("seed", (0, 1, 2))
def test_curves_match_sklearn(seed, pos_label):
    y, s = _scores(seed)
    for c in range(y.shape[1]):
        for got, want in zip(tmt.roc_curve(y[:, c], s[:, c], pos_label=pos_label),
                             skm.roc_curve(y[:, c], s[:, c], pos_label=pos_label)):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(tmt.precision_recall_curve(y[:, c], s[:, c], pos_label=pos_label),
                             skm.precision_recall_curve(y[:, c], s[:, c],
                                                        pos_label=pos_label)):
            np.testing.assert_array_equal(got, want)
        assert tmt.average_precision_score(y[:, c], s[:, c], pos_label=pos_label) == \
            skm.average_precision_score(y[:, c], s[:, c], pos_label=pos_label)


@pytest.mark.parametrize("micro_and_macro", (False, True))
@pytest.mark.parametrize("pos_label", (0, 1))
def test_roc_and_prisofs_match_gnn_tpu(micro_and_macro, pos_label, monkeypatch):
    # gnn_tpu renders every figure; the port draws one only for a save path
    monkeypatch.setattr(jmt, "_render_curves", lambda *a, **k: None)
    y, s = _scores(5)
    want = jmt.ROC(y, s, "", micro_and_macro, pos_label=pos_label)
    got = tmt.ROC(y, s, "", micro_and_macro, pos_label=pos_label)
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12
    want = jmt.PRISOFS(y, s, "", pos_label=pos_label)
    got = tmt.PRISOFS(y, s, "", pos_label=pos_label)
    assert got == want


def test_degenerate_columns():
    """A target column with one class: nan rates where sklearn gives nan,
    recall 1 on the precision-recall curve."""
    y = np.zeros((10, 2))
    y[:, 1] = 1
    s = np.linspace(0, 1, 20).reshape(10, 2)
    for c in range(2):
        for got, want in zip(tmt.roc_curve(y[:, c], s[:, c], pos_label=1),
                             skm.roc_curve(y[:, c], s[:, c], pos_label=1)):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(tmt.precision_recall_curve(y[:, c], s[:, c], pos_label=1),
                             skm.precision_recall_curve(y[:, c], s[:, c], pos_label=1)):
            np.testing.assert_array_equal(got, want)


def test_figures_only_with_a_save_path(tmp_path, monkeypatch):
    y, s = _scores(3)
    roc, pr = tmp_path / "roc.png", tmp_path / "pr.png"
    tmt.ROC(y, s, str(roc), True)
    tmt.PRISOFS(y, s, str(pr))
    assert roc.stat().st_size > 0 and pr.stat().st_size > 0
    # without matplotlib: areas without a path, an ImportError naming it with one
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert tmt.ROC(y, s) == tmt.roc_curves(y, s)[2]
    with pytest.raises(ImportError, match="matplotlib"):
        tmt.PRISOFS(y, s, str(tmp_path / "x.png"))
