"""The port's SVM Genant grading (healthivert_tpu_torch/evaluation/svm.py
and grading.py, numpy only) against scikit-learn and the JAX package's
grading (healthivert_tpu/evaluation/grading.py, which calls scikit-learn
and pandas), on the RHLV tables of tests/test_grading_oracle.py's
generator (n=260, four overlapping grades), on one table with a fifth
grade of 3 members and on one with two classes (grade 0-1 against 2-3):

- the scaler's output equal to StandardScaler's, bit for bit;
- each fold's train and test indices equal to StratifiedKFold(5)'s;
- each fold's SVC (linear, balanced class weights): the support vectors
  equal to SVC's, dual_coef_ and intercept_ within 1e-6, the val
  predictions equal;
- both reports (sagittal and 2.5D) byte-equal to the JAX package's;
- the linear kernel's entries equal to BLAS `ddot`'s, which scikit-learn's
  libsvm calls;
- the metrics equal to scikit-learn's where a label is missing on a side.
"""

import numpy as np
import pandas as pd
import pytest
from sklearn import metrics as skm
from sklearn.model_selection import StratifiedKFold
from sklearn.preprocessing import StandardScaler as SkScaler
from sklearn.svm import SVC as SkSVC

from healthivert_tpu.evaluation import grading as jgrading
from healthivert_tpu_torch.evaluation import grading, svm
from test_grading_oracle import _synth_table

FEATURES = list(grading.FEATURES_SAGITTAL)


def _small_class(rng):
    """The generator's table with 3 train/test rows regraded 4 (fewer than
    the 5 folds), their features moved past grade 3's."""
    df = _synth_table(rng)
    idx = df.index[df["Dataset"] != "val"][[5, 70, 150]]
    df.loc[idx, "Label"] = 4
    df.loc[idx, FEATURES] += 0.3
    return df


def _two_class(rng):
    """The generator's table with its grades split 0-1 against 2-3."""
    df = _synth_table(rng)
    df["Label"] = (df["Label"] > 1).astype(int)
    return df


TABLES = {"synth": lambda: _synth_table(np.random.default_rng(0)),
          "small_class": lambda: _small_class(np.random.default_rng(1)),
          "two_class": lambda: _two_class(np.random.default_rng(2))}


@pytest.fixture(scope="module", params=sorted(TABLES))
def table(request, tmp_path_factory):
    df = TABLES[request.param]()
    path = tmp_path_factory.mktemp(request.param) / "sagittal.csv"
    df.to_csv(path, index=False)
    return pd.read_csv(path), str(path)


def test_scaler_folds_and_svc_equal_scikit_learn(table):
    df, _ = table
    tt, val = df[df["Dataset"].isin(["train", "test"])], df[df["Dataset"] == "val"]
    x, y = tt[FEATURES].to_numpy(), tt["Label"].to_numpy()
    sk = SkScaler()
    xs, xv = sk.fit_transform(x), sk.transform(val[FEATURES].to_numpy())
    mine = svm.StandardScaler()
    np.testing.assert_array_equal(mine.fit_transform(x), xs)
    np.testing.assert_array_equal(mine.transform(val[FEATURES].to_numpy()), xv)
    folds = list(svm.stratified_kfold(y, 5))
    assert len(folds) == 5
    for (tr, te), (tr_sk, te_sk) in zip(folds, StratifiedKFold(n_splits=5).split(xs, y)):
        np.testing.assert_array_equal(tr, tr_sk)
        np.testing.assert_array_equal(te, te_sk)
        ref = SkSVC(kernel="linear", class_weight="balanced").fit(xs[tr], y[tr])
        clf = svm.SVC().fit(xs[tr], y[tr])
        np.testing.assert_array_equal(clf.classes_, ref.classes_)
        np.testing.assert_array_equal(clf.support_, ref.support_)
        np.testing.assert_array_equal(clf.n_support_, ref.n_support_)
        np.testing.assert_allclose(clf.dual_coef_, ref.dual_coef_, atol=1e-6, rtol=0)
        np.testing.assert_allclose(clf.intercept_, ref.intercept_, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(clf.predict(xv), ref.predict(xv))


def test_linear_kernel_rounds_as_blas_ddot(table):
    """The SVC's kernel is `x @ y.T`; scikit-learn's dense libsvm takes each
    entry from BLAS `ddot`. A left-to-right sum rounds some entries apart."""
    from scipy.linalg.blas import ddot

    df, _ = table
    x = svm.StandardScaler().fit_transform(df[FEATURES].to_numpy())[:64]
    want = np.array([[ddot(a, b) for b in x] for a in x])
    np.testing.assert_array_equal(x @ x.T, want)


def test_reports_byte_equal_the_jax_package(table, tmp_path):
    df, path = table
    want = jgrading.evaluate_svm(path, FEATURES, str(tmp_path / "jax.txt"))
    got = grading.evaluate_svm(path, FEATURES, str(tmp_path / "port.txt"))
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    assert got == want
    # 2.5D: a coronal table of the same vertebrae in another row order,
    # one vertebra missing, features shifted
    cor = df.sample(frac=1.0, random_state=0).iloc[1:].copy()
    cor[FEATURES] = cor[FEATURES] * 0.9 + 0.01
    cor_path = str(tmp_path / "coronal.csv")
    cor.to_csv(cor_path, index=False)
    want = jgrading.evaluate_svm_25d(path, cor_path, str(tmp_path / "jax25.txt"))
    got = grading.evaluate_svm_25d(path, cor_path, str(tmp_path / "port25.txt"))
    assert (tmp_path / "port25.txt").read_bytes() == (tmp_path / "jax25.txt").read_bytes()
    assert got == want


@pytest.mark.parametrize("y_true, y_pred", [
    ([0, 1, 2, 3, 3, 2], [0, 1, 2, 3, 3, 2]),
    ([0, 0, 1, 2, 3, 3], [0, 3, 1, 1, 3, 0]),
    ([0, 2, 2, 3], [0, 0, 1, 1]),  # a predicted label never true, a true one never predicted
    ([2, 2, 2], [3, 3, 3]),
])
def test_metrics_equal_scikit_learn(y_true, y_pred):
    yt, yp = np.array(y_true), np.array(y_pred)
    cm = svm.confusion_matrix(yt, yp)
    ref = skm.confusion_matrix(yt, yp)
    assert cm.dtype == ref.dtype and str(cm) == str(ref)
    assert svm.f1_score(yt, yp) == skm.f1_score(yt, yp, average="macro")
    assert svm.precision_score(yt, yp) == skm.precision_score(yt, yp, average="macro",
                                                              zero_division=0)
    assert svm.recall_score(yt, yp) == skm.recall_score(yt, yp, average="macro",
                                                        zero_division=0)
    assert svm.accuracy_score(yt, yp) == skm.accuracy_score(yt, yp)


def test_folds_raise_when_every_class_is_smaller_than_the_folds():
    with pytest.raises(ValueError, match="n_splits=5"):
        list(svm.stratified_kfold([0, 0, 1, 1, 2, 2, 2, 2], 5))
