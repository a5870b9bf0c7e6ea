"""scikit-learn's LinearSVC, as the UNC evaluation calls it, without
scikit-learn: numpy around LIBLINEAR's three solvers in
csrc/linear_svc.cpp, which g++ builds into build/torch_kernels/ at first
use (ops/build.py) and ctypes binds.

What LinearSVC.fit does with its defaults (sklearn 1.9: svm/_classes.py
LinearSVC.fit, svm/_base.py:_fit_liblinear) and this copy keeps:
  * X as float64, the classes as np.unique(y) encoded 0..k-1;
  * dual="auto": the dual coordinate-descent solver where n_samples <
    n_features, the primal trust-region Newton solver otherwise;
    multi_class="crammer_singer" its own solver;
  * squared hinge, L2, tol 1e-4, C; the intercept as a constant feature
    of value intercept_scaling = 1, regularised like the others;
  * one-vs-rest for three classes or more, one problem for two (the
    second class positive); crammer_singer on two classes keeps
    coef_ = w1 - w0 and intercept_ = b1 - b0;
  * the solvers' permutation RNG seeded per fit with
    RandomState(random_state).randint(2**31 - 1) (svm/_base.py:1288);
  * the primal solver's BLAS level-1 calls go to scipy's BLAS, as
    scikit-learn's do, where scipy is installed (plain loops otherwise:
    the same numbers to rounding, another summation order).
Not kept: sparse input, class and sample weights, other losses and
penalties, the ConvergenceWarning.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from ..ops.build import PACKAGE_DIR, build_shared_library

_SRC = PACKAGE_DIR / "csrc" / "linear_svc.cpp"
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_BLAS = None            # scipy's BLAS entry points for TRON (_scipy_blas)

_DUAL, _PRIMAL, _CRAMMER_SINGER = 1, 2, 4
_TOL = 1e-4             # LinearSVC's default tol, which the evaluation keeps


def _lib() -> ctypes.CDLL:
    """Build (once per process, g++ -O2) and load the solver library;
    raises if there is no compiler — the evaluation has no other way."""
    global _LIB, _BLAS
    with _LOCK:
        if _LIB is None:
            path, _, _ = build_shared_library(
                ["g++", "-O2", "-std=c++17", "-shared", "-fPIC"], _SRC,
                "_linear_svc.so")
            lib = ctypes.CDLL(str(path))
            p, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
            lib.dmp_linear_svc_train.restype = i32
            lib.dmp_linear_svc_train.argtypes = [
                p, i32, i32, p, i32, i32, f64, f64, f64, i32, ctypes.c_uint,
                p, p, p, p, p, p]
            _BLAS = _scipy_blas()
            _LIB = lib
    return _LIB


def _scipy_blas():
    """Pointers to scipy's ddot, daxpy, dscal and dnrm2 (the functions
    scikit-learn hands LIBLINEAR), or four None."""
    try:
        from scipy.linalg import cython_blas
    except ImportError:
        return [None] * 4
    api = ctypes.pythonapi
    api.PyCapsule_GetName.restype = ctypes.c_char_p
    api.PyCapsule_GetName.argtypes = [ctypes.py_object]
    api.PyCapsule_GetPointer.restype = ctypes.c_void_p
    api.PyCapsule_GetPointer.argtypes = [ctypes.py_object, ctypes.c_char_p]
    out = []
    for name in ("ddot", "daxpy", "dscal", "dnrm2"):
        cap = cython_blas.__pyx_capi__[name]
        out.append(api.PyCapsule_GetPointer(cap, api.PyCapsule_GetName(cap)))
    return out


class LinearSVC:
    """LinearSVC(C, max_iter, multi_class, random_state) with sklearn's
    defaults for everything else: fit, decision_function, predict,
    coef_, intercept_, classes_, n_iter_. random_state is an int seed."""

    def __init__(self, C: float, max_iter: int, multi_class: str,
                 random_state: int):
        if multi_class not in ("ovr", "crammer_singer"):
            raise ValueError(f"multi_class {multi_class!r}")
        self.C = C
        self.max_iter = max_iter
        self.multi_class = multi_class
        self.random_state = random_state

    def fit(self, X, y) -> "LinearSVC":
        X = np.ascontiguousarray(X, dtype=np.float64)
        y = np.asarray(y)
        if X.ndim != 2 or len(X) != len(y):
            raise ValueError(f"X {X.shape} and y {y.shape} do not match")
        self.classes_, y_ind = np.unique(y, return_inverse=True)
        k = len(self.classes_)
        if k < 2:
            raise ValueError("This solver needs samples of at least 2 "
                             "classes in the data, but the data contains "
                             f"only one class: {self.classes_[0]!r}")
        if self.multi_class == "crammer_singer":
            solver = _CRAMMER_SINGER
        else:
            solver = _DUAL if X.shape[0] < X.shape[1] else _PRIMAL
        rows = 1 if k == 2 and solver != _CRAMMER_SINGER else k
        raw = np.zeros((rows, X.shape[1] + 1), np.float64)
        n_iter = np.zeros(rows, np.int32)
        y_ind = np.ascontiguousarray(y_ind, dtype=np.int32)
        # check_random_state(random_state).randint(np.iinfo("i").max)
        seed = int(np.random.RandomState(self.random_state).randint(
            np.iinfo("i").max))
        rc = _lib().dmp_linear_svc_train(
            X.ctypes.data, X.shape[0], X.shape[1], y_ind.ctypes.data, k,
            solver, _TOL, float(self.C), 1.0, int(self.max_iter), seed,
            raw.ctypes.data, n_iter.ctypes.data, *_BLAS)
        if rc != 0:
            raise ValueError(f"linear_svc: bad arguments (code {rc})")
        self.coef_, self.intercept_ = raw[:, :-1], raw[:, -1].copy()
        self.n_iter_ = int(n_iter.max())
        if self.multi_class == "crammer_singer" and k == 2:
            self.coef_ = (self.coef_[1] - self.coef_[0]).reshape(1, -1)
            self.intercept_ = np.array([self.intercept_[1]
                                        - self.intercept_[0]])
        return self

    def decision_function(self, X) -> np.ndarray:
        scores = np.asarray(X) @ self.coef_.T + self.intercept_
        return scores.ravel() if scores.shape[1] == 1 else scores

    def predict(self, X) -> np.ndarray:
        scores = self.decision_function(X)
        idx = (scores > 0).astype(int) if scores.ndim == 1 \
            else scores.argmax(axis=1)
        return self.classes_[idx]
