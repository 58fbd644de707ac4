"""Metric registry, ROC and precision-recall reporting (counterpart of
gnn_tpu/metrics.py), in numpy.

gnn_tpu's registry names scikit-learn's functions; these are the same
functions for class labels given as 1-D arrays, with scikit-learn's
defaults and keyword arguments: `average='binary'` with `pos_label=1`
(ValueError on more than two classes, as scikit-learn raises), 'micro',
'macro', 'weighted' or None; `labels`, `sample_weight`; 0.0 where a ratio
divides by zero ('warn', the default, or `zero_division=0`), 1.0 or nan
where asked. Curves follow `roc_curve` (drop_intermediate=True) and
`precision_recall_curve`. Figures are drawn only when a save path is given,
and only then is matplotlib imported.
"""

from __future__ import annotations

import numpy as np


# ------------------------------------------------------------------ labels
def _column(y) -> np.ndarray:
    y = np.asarray(y)
    if y.ndim == 2 and y.shape[1] == 1:
        y = y[:, 0]
    if y.ndim != 1:
        raise ValueError(f"labels must be a 1-D array, got shape {y.shape}")
    return y


def _integral(y: np.ndarray) -> bool:
    return y.dtype.kind in "biu" or (y.dtype.kind == "f" and bool(np.all(np.mod(y, 1) == 0)))


def _targets(y_true, y_pred):
    """(y_type 'binary' | 'multiclass', sorted present labels, y_true, y_pred)."""
    y_true, y_pred = _column(y_true), _column(y_pred)
    if len(y_true) != len(y_pred):
        raise ValueError(f"Found input variables with inconsistent numbers of samples: "
                         f"[{len(y_true)}, {len(y_pred)}]")
    if not (_integral(y_true) and _integral(y_pred)):
        raise ValueError("Classification metrics can't handle continuous targets")
    present = np.union1d(y_true, y_pred)
    return ("binary" if len(present) <= 2 else "multiclass"), present, y_true, y_pred


def _set_wise_labels(y_true, y_pred, average, labels, pos_label):
    """scikit-learn's _check_set_wise_labels: the labels scored."""
    options = (None, "micro", "macro", "weighted", "samples")
    if average not in options and average != "binary":
        raise ValueError("average has to be one of " + str(options))
    y_type, present, y_true, y_pred = _targets(y_true, y_pred)
    if average == "binary":
        if y_type != "binary":
            raise ValueError(f"Target is {y_type} but average='binary'. Please choose another "
                             f"average setting, one of {[None, 'micro', 'macro', 'weighted']}.")
        if pos_label not in present and len(present) >= 2:
            raise ValueError(f"pos_label={pos_label} is not a valid label. It should be one "
                             f"of {present}")
        labels = [pos_label]
    if average == "samples":
        raise ValueError("Samplewise metrics are not available outside of multilabel "
                         "classification.")
    return (present if labels is None else np.asarray(labels)), y_true, y_pred


def _per_label(y_true, y_pred, labels, sample_weight):
    """(tp, predicted, true) sums for each label, weighted."""
    w = np.ones(len(y_true)) if sample_weight is None else np.asarray(sample_weight, np.float64)
    t = y_true[None, :] == np.asarray(labels)[:, None]
    p = y_pred[None, :] == np.asarray(labels)[:, None]
    if sample_weight is None:
        return (t & p).sum(1), p.sum(1), t.sum(1)
    return (w * (t & p)).sum(1), (w * p).sum(1), (w * t).sum(1)


def _zero_division_value(zero_division):
    if isinstance(zero_division, str) and zero_division == "warn":
        return 0.0
    if zero_division in (0, 1):
        return float(zero_division)
    if isinstance(zero_division, float) and np.isnan(zero_division):
        return np.nan
    raise ValueError(f"zero_division must be 'warn', 0, 1 or nan, got {zero_division!r}")


def _divide(num, den, zero_division):
    num, den = np.asarray(num, np.float64), np.asarray(den, np.float64)
    mask = den == 0
    out = num / np.where(mask, 1.0, den)
    out[mask] = _zero_division_value(zero_division)
    return out


def _nanaverage(a, weights=None):
    if a.shape[0] == 0:
        return np.nan
    keep = ~np.isnan(a)
    if not keep.any():
        return np.nan
    if weights is None:
        return np.mean(a[keep])
    w = np.asarray(weights)[keep]
    return np.average(a[keep], weights=w) if w.sum() else np.average(a[keep])


def _prf(y_true, y_pred, *, labels=None, pos_label=1, average="binary", sample_weight=None,
         zero_division="warn"):
    """(precision, recall, f1) as precision_recall_fscore_support (beta 1)."""
    _zero_division_value(zero_division)
    labels, y_true, y_pred = _set_wise_labels(y_true, y_pred, average, labels, pos_label)
    tp, pred, true = _per_label(y_true, y_pred, labels, sample_weight)
    if average == "micro":
        tp, pred, true = (np.atleast_1d(x.sum()) for x in (tp, pred, true))
    precision = _divide(tp, pred, zero_division)
    recall = _divide(tp, true, zero_division)
    f1 = _divide(2.0 * np.asarray(tp, np.float64),
                 np.asarray(true, np.float64) + np.asarray(pred, np.float64), zero_division)
    if average is None:
        return precision, recall, f1
    weights = true if average == "weighted" else None
    return tuple(float(_nanaverage(x, weights)) for x in (precision, recall, f1))


def precision_score(y_true, y_pred, **kw):
    return _prf(y_true, y_pred, **kw)[0]


def recall_score(y_true, y_pred, **kw):
    return _prf(y_true, y_pred, **kw)[1]


def f1_score(y_true, y_pred, **kw):
    return _prf(y_true, y_pred, **kw)[2]


def jaccard_score(y_true, y_pred, *, labels=None, pos_label=1, average="binary",
                  sample_weight=None, zero_division="warn"):
    if not (isinstance(zero_division, str) and zero_division == "warn") and \
            zero_division not in (0, 1):
        raise ValueError(f"jaccard_score's zero_division must be 'warn', 0 or 1, got "
                         f"{zero_division!r}")
    labels, y_true, y_pred = _set_wise_labels(y_true, y_pred, average, labels, pos_label)
    tp, pred, true = _per_label(y_true, y_pred, labels, sample_weight)
    num, den = tp, true + pred - tp
    if average == "micro":
        num, den = np.atleast_1d(num.sum()), np.atleast_1d(den.sum())
    jac = _divide(num, den, zero_division)
    if average is None:
        return jac
    weights = true if average == "weighted" and np.any(true) else None
    return float(np.average(jac, weights=weights))


def accuracy_score(y_true, y_pred, *, normalize=True, sample_weight=None):
    _, _, y_true, y_pred = _targets(y_true, y_pred)
    score = (y_true == y_pred).astype(np.float64)
    if normalize:
        return float(np.average(score, weights=sample_weight))
    return float(score.sum() if sample_weight is None else np.dot(score, sample_weight))


def confusion_matrix(y_true, y_pred, *, labels=None, sample_weight=None):
    """C[i, j]: samples of true label labels[i] predicted labels[j] (labels
    default to the sorted union); samples with other labels are left out."""
    _, present, y_true, y_pred = _targets(y_true, y_pred)
    labels = present if labels is None else np.asarray(labels)
    if len(labels) == 0:
        raise ValueError("'labels' should contains at least one label.")
    if not np.isin(y_true, labels).any():
        raise ValueError("At least one label specified must be in y_true")
    w = (np.ones(len(y_true), dtype=np.int64) if sample_weight is None
         else np.asarray(sample_weight))
    keep = np.isin(y_true, labels) & np.isin(y_pred, labels)
    order = np.argsort(labels, kind="stable")
    ti = order[np.searchsorted(labels[order], y_true[keep])]
    pi = order[np.searchsorted(labels[order], y_pred[keep])]
    out = np.zeros((len(labels), len(labels)), dtype=w.dtype if w.dtype.kind == "f"
                   else np.int64)
    np.add.at(out, (ti, pi), w[keep])
    return out


def balanced_accuracy_score(y_true, y_pred, *, sample_weight=None, adjusted=False):
    C = confusion_matrix(y_true, y_pred, sample_weight=sample_weight)
    with np.errstate(divide="ignore", invalid="ignore"):
        per_class = np.diag(C) / C.sum(axis=1)
    per_class = per_class[~np.isnan(per_class)]
    score = np.mean(per_class)
    if adjusted:
        chance = 1 / per_class.shape[0]
        score = (score - chance) / (1 - chance)
    return float(score)


def cohen_kappa_score(y1, y2, *, labels=None, weights=None, sample_weight=None,
                      replace_undefined_by=np.nan):
    confusion = confusion_matrix(y1, y2, labels=labels,
                                 sample_weight=sample_weight).astype(np.float64)
    n = confusion.shape[0]
    sum0, sum1 = confusion.sum(axis=0), confusion.sum(axis=1)
    total = sum0.sum()
    if total == 0:
        return replace_undefined_by
    expected = np.outer(sum0, sum1) / total
    if weights is None:
        w = np.ones((n, n)) - np.eye(n)
    elif weights in ("linear", "quadratic"):
        w = np.zeros((n, n)) + np.arange(n)
        w = np.abs(w - w.T) if weights == "linear" else (w - w.T) ** 2
    else:
        raise ValueError(f"weights must be None, 'linear' or 'quadratic', got {weights!r}")
    den = np.sum(w * expected)
    if den == 0:
        return replace_undefined_by
    return float(1 - np.sum(w * confusion) / den)


# --------------------------------------------------------------------- rates
def TPR(y_true, y_pred):
    return recall_score(y_true, y_pred)


def TNR(y_true, y_pred):
    return 2 * balanced_accuracy_score(y_true, y_pred) - recall_score(y_true, y_pred)


def FPR(y_true, y_pred):
    return 1 - TNR(y_true, y_pred)


def FNR(y_true, y_pred):
    return 1 - TPR(y_true, y_pred)


def accuracy_per_class(y_true, y_pred, class_label: int = None):
    mat = confusion_matrix(y_true, y_pred)
    with np.errstate(divide="ignore", invalid="ignore"):
        class_accuracy = np.diag(mat) / np.sum(mat, axis=1)
    return class_accuracy if class_label is None else class_accuracy[class_label]


# -------------------------------------------------------------------- curves
def _at_thresholds(y_true, y_score, pos_label):
    """(fps, tps, thresholds) of confusion_matrix_at_thresholds: counts of
    negatives and positives scored at or above each distinct score, scores
    descending."""
    y_true, y_score = _column(y_true), _column(y_score)
    if not _integral(y_true):
        raise ValueError("continuous format is not supported")
    if not (np.isfinite(y_score).all() and np.isfinite(y_true.astype(np.float64)).all()):
        raise ValueError("Input contains NaN or infinity.")
    y = (y_true == pos_label).astype(np.float64)
    # stable descending order, ties in input order
    order = len(y_score) - 1 - np.flip(np.argsort(np.flip(y_score), kind="stable"))
    y_score, y = y_score[order], y[order]
    idx = np.concatenate([np.nonzero(np.diff(y_score))[0], [len(y) - 1]])
    tps = np.cumsum(y)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    return fps, tps, y_score[idx]


def roc_curve(y_true, y_score, *, pos_label=1):
    """(fpr, tpr, thresholds) as scikit-learn's roc_curve with
    drop_intermediate=True; nan rates where a class is absent."""
    fps, tps, thr = _at_thresholds(y_true, y_score, pos_label)
    if fps.shape[0] > 2:
        keep = np.concatenate([[True], np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), [True]])
        fps, tps, thr = fps[keep], tps[keep], thr[keep]
    tps, fps = np.concatenate([[0.0], tps]), np.concatenate([[0.0], fps])
    thr = np.concatenate([[np.inf], thr.astype(np.float64)])
    fpr = np.full(fps.shape, np.nan) if fps[-1] <= 0 else fps / fps[-1]
    tpr = np.full(tps.shape, np.nan) if tps[-1] <= 0 else tps / tps[-1]
    return fpr, tpr, thr


def precision_recall_curve(y_true, y_score, *, pos_label=1):
    """(precision, recall, thresholds) as scikit-learn's precision_recall_curve."""
    fps, tps, thr = _at_thresholds(y_true, y_score, pos_label)
    ps = tps + fps
    precision = np.where(ps != 0, tps / np.where(ps != 0, ps, 1.0), 0.0)
    recall = np.ones(tps.shape) if tps[-1] == 0 else tps / tps[-1]
    return (np.concatenate([np.flip(precision), [1.0]]), np.concatenate([np.flip(recall), [0.0]]),
            np.flip(thr))


def average_precision_score(y_true, y_score, *, pos_label=1):
    """Step-function area under the precision-recall curve (binary y_true)."""
    present = np.unique(_column(y_true))
    if present.shape[0] == 2 and pos_label not in present:
        raise ValueError(f"pos_label={pos_label} is not a valid label. It should be one of "
                         f"{present}")
    precision, recall, _ = precision_recall_curve(y_true, y_score, pos_label=pos_label)
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def auc(x, y) -> float:
    """Trapezoidal area under (x, y), x monotone."""
    x, y = _column(x), _column(y)
    if x.shape[0] < 2:
        raise ValueError(f"At least 2 points are needed to compute area under curve, but "
                         f"x.shape = {x.shape}")
    direction = 1
    dx = np.diff(x)
    if np.any(dx < 0):
        if not np.all(dx <= 0):
            raise ValueError(f"x is neither increasing nor decreasing : {x}.")
        direction = -1
    trapezoid = getattr(np, "trapezoid", None) or np.trapz   # numpy < 2 has trapz only
    return float(direction * trapezoid(y, x))


# --------------------------------------------------------------------- plots
def _render_curves(curves, *, xlabel, ylabel, title, legend_loc, savedir, underlay=None,
                   cmap="Set2"):
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("drawing ROC / precision-recall figures (a save path was given) "
                          "needs matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    if underlay is not None:
        underlay(ax)
    palette = matplotlib.colormaps[cmap]
    for i, (label, x, y, lw) in enumerate(curves):
        ax.plot(x, y, color=palette(i), lw=lw, label=label)
    ax.set(xlim=(0.0, 1.0), ylim=(0.0, 1.05), xlabel=xlabel, ylabel=ylabel, title=title)
    ax.legend(loc=legend_loc, fontsize="small")
    fig.savefig(savedir)
    plt.close(fig)


def plot_roc(fpr, tpr, roc_auc, savedir, *, line_width=1.5, cmap="Set2"):
    curves = [(f"ROC curve - class {k} (area = {roc_auc[k]:0.2f})", fpr[k], tpr[k],
               line_width + (1 if isinstance(k, str) else 0)) for k in fpr]

    def chance_diagonal(ax):
        ax.plot([0, 1], [0, 1], color="navy", lw=line_width, ls="--")

    _render_curves(curves, xlabel="False Positive Rate", ylabel="True Positive Rate",
                   title="ROC - Receiver Operating Characteristic", legend_loc="lower right",
                   savedir=savedir, underlay=chance_diagonal, cmap=cmap)


def plot_prisofs(recall, precision, avg_precision, savedir, *, line_width=1.5, cmap="Set2"):
    curves = [(f"Precision-recall for class {k} (area = {avg_precision[k]:0.2f})",
               recall[k], precision[k], line_width) for k in precision]

    def iso_f1_family(ax):
        # p = f·r / (2r − f): precision giving F1 == f at recall r
        r = np.linspace(0.01, 1.0, 200)
        for f in (0.2, 0.4, 0.6, 0.8):
            p = f * r / (2.0 * r - f)
            ok = (2.0 * r - f > 0) & (p <= 1.05)
            ax.plot(r[ok], p[ok], color="gray", alpha=0.25, lw=1.0)
            ax.annotate(f"f1={f:0.1f}", xy=(0.9, f / (2 - f) + 0.02), color="gray",
                        fontsize="x-small")

    _render_curves(curves, xlabel="Recall", ylabel="Precision",
                   title="Precision-Recall curves with iso-F1 contours",
                   legend_loc="lower center", savedir=savedir, underlay=iso_f1_family, cmap=cmap)


def _binary_roc(y_col, score_col, pos_label):
    fpr, tpr, _ = roc_curve(y_col, score_col, pos_label=pos_label)
    return fpr, tpr, auc(fpr, tpr)


def roc_curves(y_test, y_score, macro_and_micro: bool = False, pos_label=0):
    """({class: fpr}, {class: tpr}, {class: auc}) per target column, with
    'micro' (every decision pooled) and 'macro' (the mean TPR on the union of
    the FPR breakpoints) when macro_and_micro."""
    y_test, y_score = np.asarray(y_test), np.asarray(y_score)
    per_class = {c: _binary_roc(y_test[:, c], y_score[:, c], pos_label)
                 for c in range(y_test.shape[1])}
    fpr = {c: v[0] for c, v in per_class.items()}
    tpr = {c: v[1] for c, v in per_class.items()}
    area = {c: v[2] for c, v in per_class.items()}
    if macro_and_micro:
        fpr["micro"], tpr["micro"], area["micro"] = _binary_roc(y_test.ravel(), y_score.ravel(),
                                                                pos_label)
        grid = np.unique(np.concatenate([v[0] for v in per_class.values()]))
        fpr["macro"] = grid
        tpr["macro"] = np.mean([np.interp(grid, v[0], v[1]) for v in per_class.values()], axis=0)
        area["macro"] = auc(grid, tpr["macro"])
    return fpr, tpr, area


def ROC(y_test, y_score, savedir="", macro_and_micro: bool = False, pos_label=0):
    """Per-class ROC AUCs (roc_curves), the figure saved to savedir when given.
    Returns {class: auc}."""
    fpr, tpr, area = roc_curves(y_test, y_score, macro_and_micro, pos_label)
    if savedir:
        plot_roc(fpr, tpr, area, savedir)
    return area


def pr_curves(targs, y_score, pos_label=0):
    """({class: precision}, {class: recall}, {class: average precision})."""
    targs, y_score = np.asarray(targs), np.asarray(y_score)
    precision, recall, avg = {}, {}, {}
    for c in range(targs.shape[1]):
        precision[c], recall[c], _ = precision_recall_curve(targs[:, c], y_score[:, c],
                                                            pos_label=pos_label)
        avg[c] = average_precision_score(targs[:, c], y_score[:, c], pos_label=pos_label)
    return precision, recall, avg


def PRISOFS(targs, y_score, savedir="", pos_label=0):
    """Per-class average precision (pr_curves), the precision-recall figure
    with iso-F1 contours saved to savedir when given. Returns {class: AP}."""
    precision, recall, avg = pr_curves(targs, y_score, pos_label)
    if savedir:
        plot_prisofs(recall, precision, avg, savedir)
    return avg


# ------------------------------------------------------------------ registry
Metrics = {"Acc": accuracy_score, "Bacc": balanced_accuracy_score, "Js": jaccard_score,
           "Ck": cohen_kappa_score, "Prec": precision_score, "Rec": recall_score, "Fs": f1_score,
           "Tpr": TPR, "Tnr": TNR, "Fpr": FPR, "Fnr": FNR, "Cl0": accuracy_per_class,
           "Cl1": accuracy_per_class}
