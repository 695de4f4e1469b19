"""The pieces of scikit-learn that the Genant grading uses, in numpy float64
on the host: a standard scaler, stratified 5-fold splits, a linear C-SVC
with balanced class weights, and the classification metrics.

The machine with the card has no scikit-learn, so the port carries its own.
Each piece follows scikit-learn's computation step for step, so that the
port's grading reports equal the JAX package's (which call scikit-learn):

- `StandardScaler`: the mean and the population variance by the corrected
  two-pass algorithm of scikit-learn's `_incremental_mean_and_var`, a
  near-constant feature scaled by 1.
- `stratified_kfold`: `StratifiedKFold(n_splits, shuffle=False)`: classes
  encoded in order of first appearance, fold i's share of each class from
  ``bincount(y_sorted[i::n_splits])``, a class's samples given to the folds
  in blocks in their order.
- `SVC`: `SVC(kernel="linear", C=1.0, class_weight="balanced")`, which is
  libsvm's C-SVC one-vs-one over the sorted labels, each pair's C scaled by
  its classes' weights n / (n_classes * count). Each pair's dual is solved
  by a port of libsvm's `Solver` (svm.cpp): second-order working-set
  selection (WSS3), tolerance 1e-3, shrinking, the kernel rows held as
  float32 as libsvm's `Qfloat`, the gradient reconstructed from G_bar, and
  rho from the free support vectors' average or the bounds' midpoint. A
  second QP method that is right only within that tolerance would move
  validation points near the boundary, so the port keeps libsvm's path.
  Prediction is libsvm's vote, ties to the lower class. The linear
  kernel's entries are BLAS dot products (`x @ y.T`): scikit-learn's dense
  libsvm computes each one with BLAS `ddot`, and numpy's BLAS rounds a dot
  of a few features as that `ddot` does (tests/test_torch_grading.py holds
  them equal), where a plain left-to-right sum differs in the last bit. A
  BLAS whose `gemm` and `ddot` round apart could move a decision value
  that lies at 0, and with it a vote.
- `confusion_matrix`, macro `precision_score` / `recall_score` / `f1_score`
  (0 where undefined) and `accuracy_score`.
"""

from __future__ import annotations

import math
from typing import Iterator, Tuple

import numpy as np

TAU = 1e-12
EPS = 1e-3  # libsvm's stopping tolerance, scikit-learn's SVC(tol=1e-3)
C = 1.0
LOWER, UPPER, FREE = 0, 1, 2


class StandardScaler:
    """Zero mean, unit population variance per feature."""

    def fit(self, x: np.ndarray) -> "StandardScaler":
        x = np.asarray(x, np.float64)
        n = float(x.shape[0])
        new_sum = np.sum(x, axis=0)
        self.mean_ = new_sum / n
        temp = x - new_sum / n
        correction = np.sum(temp, axis=0)
        temp **= 2
        unnormalized = np.sum(temp, axis=0)
        unnormalized -= correction ** 2 / n
        self.var_ = unnormalized / n
        eps = np.finfo(np.float64).eps
        constant = self.var_ <= n * eps * self.var_ + (n * self.mean_ * eps) ** 2
        self.scale_ = np.sqrt(self.var_)
        self.scale_[constant] = 1.0
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        x = np.array(x, np.float64)
        x -= self.mean_
        x /= self.scale_
        return x

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        return self.fit(x).transform(x)


def stratified_kfold(y, n_splits: int = 5) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(train indices, test indices) of each fold, as
    StratifiedKFold(n_splits).split(x, y) yields them."""
    y = np.asarray(y)
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv]
    n_classes = len(y_idx)
    y_counts = np.bincount(y_encoded)
    if np.all(n_splits > y_counts):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the number of "
                         "members in each class.")
    y_order = np.sort(y_encoded)
    allocation = np.asarray([np.bincount(y_order[i::n_splits], minlength=n_classes)
                             for i in range(n_splits)])
    test_folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        test_folds[y_encoded == k] = np.arange(n_splits).repeat(allocation[:, k])
    idx = np.arange(len(y))
    for i in range(n_splits):
        mask = test_folds == i
        yield idx[~mask], idx[mask]


class _Solver:
    """libsvm's Solver (svm.cpp, Solver::Solve) for the C-SVC dual

        min 0.5 a'Qa - e'a,  y'a = 0,  0 <= a_i <= C_i,

    Q_ij = y_i y_j K(x_i, x_j) held as float32 (libsvm's Qfloat), QD its
    diagonal in float64. The arrays are kept in libsvm's working order, which
    shrinking permutes (`_swap`)."""

    def __init__(self, q: np.ndarray, qd: np.ndarray, y: np.ndarray, c: np.ndarray):
        l = len(y)
        self.l = l
        self.Q = q.copy()
        self.QD = qd.copy()
        self.y = y.astype(np.float64)
        self.C = c.astype(np.float64)
        self.p = -np.ones(l)
        self.alpha = np.zeros(l)
        self.status = np.full(l, LOWER, np.int8)
        self.active_set = np.arange(l)
        self.active_size = l
        self.G = self.p.copy()
        self.G_bar = np.zeros(l)
        self.unshrink = False

    def _update_status(self, i):
        a = self.alpha[i]
        self.status[i] = UPPER if a >= self.C[i] else (LOWER if a <= 0 else FREE)

    def _swap(self, i, j):
        for arr in (self.y, self.G, self.status, self.alpha, self.p, self.active_set,
                    self.G_bar, self.C, self.QD):
            arr[i], arr[j] = arr[j], arr[i]
        q = self.Q
        q[[i, j]] = q[[j, i]]
        q[:, [i, j]] = q[:, [j, i]]

    def _reconstruct_gradient(self):
        a, l = self.active_size, self.l
        if a == l:
            return
        G = self.G
        G[a:] = self.G_bar[a:] + self.p[a:]
        free = np.flatnonzero(self.status[:a] == FREE)
        nr_free = len(free)
        if nr_free * l > 2 * a * (l - a):
            for j in free:  # each inactive G[i] sums its free terms in order of j
                G[a:] += self.alpha[j] * self.Q[a:, j]
        else:
            for i in free:
                G[a:] += self.alpha[i] * self.Q[i, a:]

    def _select_working_set(self):
        a = self.active_size
        y, G, st = self.y[:a], self.G[:a], self.status[:a]
        pos = y > 0
        up = np.where(pos, st != UPPER, st != LOWER)
        gmax, i = -math.inf, -1
        cand = np.flatnonzero(up)
        if cand.size:
            v = np.where(pos, -G, G)[cand]
            gmax = float(v.max())
            i = int(cand[np.flatnonzero(v == gmax)[-1]])
        low = np.where(pos, st != LOWER, st != UPPER)
        cand = np.flatnonzero(low)
        if cand.size == 0:
            return None
        yg = np.where(pos, G, -G)[cand]
        gmax2 = float(yg.max())
        if i < 0:
            return None
        grad_diff = gmax + yg
        ok = grad_diff > 0
        if not ok.any():
            return None
        cand, grad_diff, posc = cand[ok], grad_diff[ok], pos[cand[ok]]
        qi = self.Q[i, cand]
        two_yi = 2.0 * self.y[i]
        quad = np.where(posc, (self.QD[i] + self.QD[cand]) - two_yi * qi,
                        (self.QD[i] + self.QD[cand]) + two_yi * qi)
        quad = np.where(quad > 0, quad, TAU)
        obj = -(grad_diff * grad_diff) / quad
        if gmax + gmax2 < EPS:
            return None
        j = int(cand[np.flatnonzero(obj == obj.min())[-1]])
        return i, j

    def _be_shrunk(self, i, gmax1, gmax2):
        st, G = self.status[i], self.G[i]
        if st == UPPER:
            return -G > (gmax1 if self.y[i] > 0 else gmax2)
        if st == LOWER:
            return G > (gmax2 if self.y[i] > 0 else gmax1)
        return False

    def _do_shrinking(self):
        a = self.active_size
        y, G, st = self.y[:a], self.G[:a], self.status[:a]
        pos = y > 0
        gmax1 = max(np.max(-G[pos & (st != UPPER)], initial=-math.inf),
                    np.max(G[~pos & (st != LOWER)], initial=-math.inf))
        gmax2 = max(np.max(G[pos & (st != LOWER)], initial=-math.inf),
                    np.max(-G[~pos & (st != UPPER)], initial=-math.inf))
        gmax1, gmax2 = float(gmax1), float(gmax2)
        if not self.unshrink and gmax1 + gmax2 <= EPS * 10:
            self.unshrink = True
            self._reconstruct_gradient()
            self.active_size = self.l
        i = 0
        while i < self.active_size:
            if self._be_shrunk(i, gmax1, gmax2):
                self.active_size -= 1
                while self.active_size > i:
                    if not self._be_shrunk(self.active_size, gmax1, gmax2):
                        self._swap(i, self.active_size)
                        break
                    self.active_size -= 1
            i += 1

    def _step(self, i, j):
        Q, G, alpha = self.Q, self.G, self.alpha
        a = self.active_size
        C_i, C_j = self.C[i], self.C[j]
        old_i, old_j = alpha[i], alpha[j]
        ai, aj = old_i, old_j
        if self.y[i] != self.y[j]:
            quad = self.QD[i] + self.QD[j] + 2 * Q[i, j]
            if quad <= 0:
                quad = TAU
            delta = (-G[i] - G[j]) / quad
            diff = ai - aj
            ai += delta
            aj += delta
            if diff > 0:
                if aj < 0:
                    aj, ai = 0.0, diff
            elif ai < 0:
                ai, aj = 0.0, -diff
            if diff > C_i - C_j:
                if ai > C_i:
                    ai, aj = C_i, C_i - diff
            elif aj > C_j:
                aj, ai = C_j, C_j + diff
        else:
            quad = self.QD[i] + self.QD[j] - 2 * Q[i, j]
            if quad <= 0:
                quad = TAU
            delta = (G[i] - G[j]) / quad
            total = ai + aj
            ai -= delta
            aj += delta
            if total > C_i:
                if ai > C_i:
                    ai, aj = C_i, total - C_i
            elif aj < 0:
                aj, ai = 0.0, total
            if total > C_j:
                if aj > C_j:
                    aj, ai = C_j, total - C_j
            elif ai < 0:
                ai, aj = 0.0, total
        alpha[i], alpha[j] = ai, aj
        d_i, d_j = ai - old_i, aj - old_j
        G[:a] += Q[i, :a] * d_i + Q[j, :a] * d_j
        ui, uj = self.status[i] == UPPER, self.status[j] == UPPER
        self._update_status(i)
        self._update_status(j)
        if ui != (self.status[i] == UPPER):
            self.G_bar += (-C_i if ui else C_i) * Q[i]
        if uj != (self.status[j] == UPPER):
            self.G_bar += (-C_j if uj else C_j) * Q[j]

    def _calculate_rho(self):
        a = self.active_size
        y, G, st = self.y[:a], self.G[:a], self.status[:a]
        yG = y * G
        pos = y > 0
        up_side = ((st == UPPER) & ~pos) | ((st == LOWER) & pos)
        low_side = ((st == UPPER) & pos) | ((st == LOWER) & ~pos)
        free = st == FREE
        if free.any():
            return float(np.cumsum(yG[free])[-1]) / int(free.sum())
        ub = float(np.min(yG[up_side], initial=math.inf))
        lb = float(np.max(yG[low_side], initial=-math.inf))
        return (ub + lb) / 2

    def solve(self) -> Tuple[np.ndarray, float, int]:
        """(alpha in the problem's order, rho, iterations)."""
        l = self.l
        counter = min(l, 1000) + 1
        it = 0
        while True:
            counter -= 1
            if counter == 0:
                counter = min(l, 1000)
                self._do_shrinking()
            ws = self._select_working_set()
            if ws is None:
                self._reconstruct_gradient()
                self.active_size = l
                ws = self._select_working_set()
                if ws is None:
                    break
                counter = 1  # shrink on the next iteration
            it += 1
            self._step(*ws)
        rho = self._calculate_rho()
        alpha = np.empty(l)
        alpha[self.active_set] = self.alpha
        return alpha, rho, it


class SVC:
    """SVC(kernel="linear", C=1.0, class_weight="balanced") of scikit-learn
    (libsvm's C-SVC, one-vs-one, shrinking on). After `fit`: classes_,
    support_, n_support_, dual_coef_ (n_classes - 1, n_SV) and intercept_ in
    scikit-learn's layout, which for two classes negates both."""

    def fit(self, x, y) -> "SVC":
        x = np.ascontiguousarray(x, np.float64)
        classes, y_enc = np.unique(np.asarray(y), return_inverse=True)
        k = len(classes)
        if k < 2:
            raise ValueError("The number of classes has to be greater than one")
        counts = np.bincount(y_enc)
        weight = len(y_enc) / (k * counts.astype(np.float64))
        members = [np.flatnonzero(y_enc == c) for c in range(k)]
        order = np.concatenate(members)  # libsvm groups the samples by class
        kern = x @ x.T
        alphas, rhos, self.n_iter_ = {}, [], []
        for a in range(k):
            for b in range(a + 1, k):
                idx = np.concatenate([members[a], members[b]])
                ys = np.concatenate([np.ones(len(members[a])), -np.ones(len(members[b]))])
                kk = kern[np.ix_(idx, idx)]
                q = (ys[:, None] * ys[None, :] * kk).astype(np.float32).astype(np.float64)
                c = np.where(ys > 0, C * weight[a], C * weight[b])
                alpha, rho, it = _Solver(q, kk.diagonal().copy(), ys, c).solve()
                alphas[a, b] = alpha * ys
                rhos.append(rho)
                self.n_iter_.append(it)
        nonzero = np.zeros(len(y_enc), bool)  # in `order`
        start = np.concatenate([[0], np.cumsum(counts)])
        for (a, b), alpha in alphas.items():
            na = counts[a]
            nonzero[start[a]:start[a + 1]] |= alpha[:na] != 0
            nonzero[start[b]:start[b + 1]] |= alpha[na:] != 0
        self.classes_ = classes
        self.support_ = order[nonzero]
        self.n_support_ = np.array([int(nonzero[start[c]:start[c + 1]].sum()) for c in range(k)],
                                   np.int32)
        nz_start = np.concatenate([[0], np.cumsum(self.n_support_)])
        coef = np.zeros((k - 1, len(self.support_)))
        for (a, b), alpha in alphas.items():
            na = counts[a]
            coef[b - 1, nz_start[a]:nz_start[a + 1]] = alpha[:na][nonzero[start[a]:start[a + 1]]]
            coef[a, nz_start[b]:nz_start[b + 1]] = alpha[na:][nonzero[start[b]:start[b + 1]]]
        self._coef, self._rho = coef, np.array(rhos)
        self.dual_coef_ = coef.copy()
        self.intercept_ = np.array([-r if r != 0 else 0.0 for r in rhos])
        if k == 2:  # scikit-learn flips the sign of a binary model
            self.dual_coef_ *= -1
            self.intercept_ *= -1
        self.support_vectors_ = x[self.support_]
        return self

    def predict(self, x) -> np.ndarray:
        """libsvm's one-vs-one vote; a tie goes to the lower class."""
        x = np.ascontiguousarray(x, np.float64)
        k = len(self.classes_)
        kv = x @ self.support_vectors_.T  # (n, n_SV)
        start = np.concatenate([[0], np.cumsum(self.n_support_)])
        votes = np.zeros((len(x), k), np.int64)
        p = 0
        for a in range(k):
            for b in range(a + 1, k):
                sa, sb = slice(start[a], start[a + 1]), slice(start[b], start[b + 1])
                terms = np.concatenate([self._coef[b - 1, sa] * kv[:, sa],
                                        self._coef[a, sb] * kv[:, sb]], axis=1)
                total = np.cumsum(terms, axis=1)[:, -1] if terms.shape[1] else np.zeros(len(x))
                dec = total - self._rho[p]
                votes[:, a] += dec > 0
                votes[:, b] += ~(dec > 0)
                p += 1
        return self.classes_[np.argmax(votes, axis=1)]


def _labels(y_true, y_pred) -> np.ndarray:
    return np.unique(np.concatenate([np.asarray(y_true), np.asarray(y_pred)]))


def confusion_matrix(y_true, y_pred) -> np.ndarray:
    """Rows true, columns predicted, over the sorted union of labels (int64)."""
    labels = _labels(y_true, y_pred)
    t = np.searchsorted(labels, np.asarray(y_true))
    p = np.searchsorted(labels, np.asarray(y_pred))
    cm = np.zeros((len(labels), len(labels)), np.int64)
    np.add.at(cm, (t, p), 1)
    return cm


def _divide(num, den) -> np.ndarray:
    den = np.asarray(den, np.float64)
    mask = den == 0
    den = den.copy()
    den[mask] = 1
    out = np.asarray(num, np.float64) / den
    out[mask] = 0.0
    return out


def _prf(y_true, y_pred):
    cm = confusion_matrix(y_true, y_pred)
    tp = np.diag(cm)
    pred_sum, true_sum = cm.sum(axis=0), cm.sum(axis=1)
    precision = _divide(tp, pred_sum)
    recall = _divide(tp, true_sum)
    f = _divide(2.0 * tp.astype(np.float64), 1.0 * true_sum.astype(np.float64)
                + pred_sum.astype(np.float64))
    return precision, recall, f


def precision_score(y_true, y_pred) -> float:
    """Macro precision; a class never predicted counts 0."""
    return float(np.nanmean(_prf(y_true, y_pred)[0]))


def recall_score(y_true, y_pred) -> float:
    """Macro recall; a class never true counts 0."""
    return float(np.nanmean(_prf(y_true, y_pred)[1]))


def f1_score(y_true, y_pred) -> float:
    """Macro F1; 0 for a class neither true nor predicted."""
    return float(np.nanmean(_prf(y_true, y_pred)[2]))


def accuracy_score(y_true, y_pred) -> float:
    return float(np.average(np.asarray(y_true) == np.asarray(y_pred)))
