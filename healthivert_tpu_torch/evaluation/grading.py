"""SVM Genant grading from RHLV features.

Counterpart of healthivert_tpu/evaluation/grading.py:24-105, with the
port's own scaler, folds, SVC and metrics (`evaluation.svm`) and table
(`utils.table`) in place of scikit-learn and pandas: the scaler fit on the
train+test rows and applied to the val rows, a linear SVC with balanced
class weights trained on each of 5 stratified folds of train+test and
scored on val, and the report (per-fold confusion matrix, macro F1,
precision, recall and accuracy, then their means and variances) written
byte for byte as the JAX package writes it. The 2.5D grading joins the
sagittal and coronal tables on 'Vertebra' into 6 features.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..utils.table import merge_on, read_rows
from .svm import (
    SVC,
    StandardScaler,
    accuracy_score,
    confusion_matrix,
    f1_score,
    precision_score,
    recall_score,
    stratified_kfold,
)

FEATURES_SAGITTAL: Sequence[str] = ("Pre RHLV", "Mid RHLV", "Post RHLV")
FEATURES_25D: Sequence[str] = (
    "Pre RHLV_sag", "Mid RHLV_sag", "Post RHLV_sag",
    "Pre RHLV_cor", "Mid RHLV_cor", "Post RHLV_cor",
)


def _xy(rows, features):
    # column-major, as pandas hands the JAX package its feature columns: the
    # scaler's column sums then add in numpy's pairwise order there too, and
    # the scaled features (so the SVC's float32 kernel rows) come out the same
    x = np.array([[r[f] for f in features] for r in rows], np.float64).reshape(-1, len(features))
    return np.asfortranarray(x), np.array([r["Label"] for r in rows])


def evaluate_svm(table, features: Sequence[str], output_txt: str) -> dict:
    """Grade the rows of `table` (a path, or rows as from `merge_25d`) and
    write the report to `output_txt`; returns the mean and variance of each
    metric over the folds."""
    data = read_rows(table) if isinstance(table, str) else list(table)
    x_tt, y_tt = _xy([r for r in data if r["Dataset"] in ("train", "test")], features)
    x_val, y_val = _xy([r for r in data if r["Dataset"] == "val"], features)

    scaler = StandardScaler()
    x_tt = scaler.fit_transform(x_tt)
    x_val = scaler.transform(x_val)

    folds = []
    for train_idx, _ in stratified_kfold(y_tt, n_splits=5):
        clf = SVC().fit(x_tt[train_idx], y_tt[train_idx])
        pred = clf.predict(x_val)
        folds.append(dict(
            cm=confusion_matrix(y_val, pred),
            f1=f1_score(y_val, pred),
            precision=precision_score(y_val, pred),
            recall=recall_score(y_val, pred),
            accuracy=accuracy_score(y_val, pred),
        ))

    summary = {
        k: dict(mean=float(np.mean([f[k] for f in folds])), var=float(np.var([f[k] for f in folds])))
        for k in ("f1", "precision", "recall", "accuracy")
    }
    with open(output_txt, "w") as f:
        for i, fold in enumerate(folds):
            f.write(f"Fold {i + 1}:\nConfusion Matrix:\n{fold['cm']}\n")
            f.write(
                f"F1 Score: {fold['f1']}, Precision: {fold['precision']}, "
                f"Recall: {fold['recall']}, Accuracy: {fold['accuracy']}\n\n"
            )
        f.write("Average Scores:\n")
        f.write(f"Average F1 Score: {summary['f1']['mean']} (Variance: {summary['f1']['var']})\n")
        f.write(f"Average Precision: {summary['precision']['mean']} (Variance: {summary['precision']['var']})\n")
        f.write(f"Average Recall: {summary['recall']['mean']} (Variance: {summary['recall']['var']})\n")
        f.write(f"Average Accuracy: {summary['accuracy']['mean']} (Variance: {summary['accuracy']['var']})\n")
    print(f"Results saved to {output_txt}")
    return summary


def merge_25d(sagittal_path: str, coronal_path: str):
    """Join the sagittal and coronal RHLV tables on Vertebra: (rows, the 6
    feature names)."""
    merged = merge_on(read_rows(sagittal_path), read_rows(coronal_path), "Vertebra",
                      ["Vertebra", "Pre RHLV", "Mid RHLV", "Post RHLV"],
                      suffixes=("_sag", "_cor"))
    features: List[str] = list(FEATURES_25D)
    return merged, features


def evaluate_svm_25d(sagittal_path: str, coronal_path: str, output_txt: str) -> dict:
    merged, features = merge_25d(sagittal_path, coronal_path)
    return evaluate_svm(merged, features, output_txt)
