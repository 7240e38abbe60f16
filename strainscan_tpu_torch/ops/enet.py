"""Positive Elastic-Net with cross-validated alpha path.

Port of ``strainscan_tpu/ops/enet.py`` (which replaces sklearn's
``ElasticNetCV``/``ElasticNet`` as used by the reference,
identify_strains_L2_Enet_Pscan_new_sp.py:433-456).  The host helpers are
copies of the JAX package's; only the fold Grams move to torch:
``X^T diag(t_f) X`` for every fold (the all-ones full-data fold included)
as float64 matrix products over row blocks on ``device``
(:func:`..ops.l2.fold_grams`), or, on a mesh of several positions above
``cfg.shard_min_l2_rows`` rows, as per-position partials summed across the
mesh.  The strain matrix is 0/1, so every Gram entry is an integer count
<= n, far below 2**53: float64 sums are exact in any order and equal the
JAX int32 Grams.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from strainscan_tpu.config import IdentifyConfig
from strainscan_tpu_torch.ops import l2
from strainscan_tpu_torch.parallel import sharded as psh


def shuffle_split_masks(n: int, n_splits: int, test_size: float,
                        seed: int) -> np.ndarray:
    """Boolean test-row masks [n_splits, n] identical to sklearn's
    ShuffleSplit(random_state=seed) fold structure."""
    rng = np.random.RandomState(seed)
    n_test = int(np.ceil(test_size * n))
    masks = np.zeros((n_splits, n), dtype=bool)
    for i in range(n_splits):
        perm = rng.permutation(n)
        masks[i, perm[:n_test]] = True
    return masks


def alpha_grid(X: np.ndarray, y: np.ndarray, l1_ratio: float, eps: float,
               n_alphas: int, Xty: "np.ndarray | None" = None) -> np.ndarray:
    """sklearn _alpha_grid: descending logspace from alpha_max."""
    n = X.shape[0]
    if Xty is None:
        Xty = X.T @ y
    alpha_max = np.abs(Xty).max() / (n * l1_ratio)
    if alpha_max <= np.finfo(float).resolution:
        alpha_max = np.finfo(float).resolution
    return np.logspace(np.log10(alpha_max * eps), np.log10(alpha_max),
                       num=n_alphas)[::-1]


def _cd_gram(gram: np.ndarray, moment: np.ndarray, n: int, alpha: float,
             l1_ratio: float, w0: np.ndarray, max_iter: int, tol: float,
             positive: bool) -> np.ndarray:
    """Cyclic coordinate descent on the Gram formulation.

    Minimizes 0.5 w^T G w - b^T w + n*alpha*l1r*||w||_1
    + (n*alpha*(1-l1r)/2)||w||^2 where G = X^T X, b = X^T y over the
    (possibly masked) rows — equivalent to the sklearn objective times n.
    """
    s = gram.shape[0]
    l1 = n * alpha * l1_ratio
    l2 = n * alpha * (1.0 - l1_ratio)
    w = w0.copy()
    q = gram @ w
    diag = np.diag(gram)
    for _ in range(max_iter):
        w_max = 0.0
        d_w_max = 0.0
        for j in range(s):
            if diag[j] + l2 == 0.0:
                continue
            rho = moment[j] - q[j] + diag[j] * w[j]
            if positive:
                new = max(rho - l1, 0.0) / (diag[j] + l2)
            else:
                new = (np.sign(rho) * max(abs(rho) - l1, 0.0)
                       / (diag[j] + l2))
            delta = new - w[j]
            if delta != 0.0:
                q += gram[:, j] * delta
                w[j] = new
            d_w_max = max(d_w_max, abs(delta))
            w_max = max(w_max, abs(new))
        if w_max == 0.0 or d_w_max / max(w_max, 1e-300) < tol:
            break
    return w


def _fold_grams(X: np.ndarray, y: np.ndarray, train: np.ndarray, device,
                block: int = l2.GRAM_BLOCK,
                min_shard_rows: "int | None" = None):
    """Per-fold Grams ``X^T diag(t_f) X`` and moments ``X^T (t_f * y)``.

    The Grams accumulate over row blocks on ``device`` in float64, so
    device memory is O(F * block * s) and the [F, n, s] fold-replicated
    design is never built.  With ``min_shard_rows`` set (the caller sets it
    only for a 0/1 matrix) and ``l2_mesh`` granting a mesh, the k-mer axis
    splits over the mesh (int8 rows, zero-padded) and the per-position
    Grams are summed.
    Moments are s-sized and computed on the host in float64, as in the JAX
    package.  Returns float64 NumPy arrays ``([F, s, s], [F, s])``."""
    n, s = X.shape
    F = train.shape[0]
    # one [F, n] @ [n, s] GEMM instead of F matvecs
    moments = (train * y).astype(np.float64) @ X.astype(np.float64)
    mesh = psh.resolve_mesh(device)
    if min_shard_rows is not None:
        sh = psh.l2_mesh(mesh, n, min_shard_rows)
        if sh is not None:
            pad = psh.pad_rows(sh, n) - n
            X8 = np.pad(X.astype(np.int8), ((0, pad), (0, 0)))
            T8 = np.pad(train.astype(np.int8), ((0, 0), (0, pad)))
            grams = psh.sharded_fold_grams(
                sh, psh.shard_rows(sh, X8), psh.shard_rows(sh, T8, axis=1))
            return grams, moments
    dev = mesh.first
    grams = l2.fold_grams(torch.from_numpy(np.ascontiguousarray(X)).to(dev),
                          torch.from_numpy(np.ascontiguousarray(train)).to(dev),
                          block)
    return grams.cpu().numpy(), moments


def _cd_path_all_folds(grams: np.ndarray, moments: np.ndarray,
                       n_train: np.ndarray, alphas: np.ndarray, l1r: float,
                       max_iter: int, tol: float) -> np.ndarray:
    """W [A, F, s]: per-fold CD solutions along the alpha path.

    Each fold runs the SAME warm-started cyclic coordinate descent as
    :func:`_cd_gram` called alpha-by-alpha; the native kernel
    (native/fastx.c::enet_cd_path) executes it in one C call — the
    per-coordinate Python loop was 26-41% of a warm identify sample at
    E. coli L2 scale (round-4 VERDICT weak #2)."""
    F, s = moments.shape
    A = int(alphas.size)
    from strainscan_tpu import native

    lib = native.get_lib()
    if lib is not None and hasattr(lib, "enet_cd_path"):
        import ctypes

        g = np.ascontiguousarray(grams, dtype=np.float64)
        m = np.ascontiguousarray(moments, dtype=np.float64)
        nt = np.ascontiguousarray(n_train, dtype=np.float64)
        al = np.ascontiguousarray(alphas, dtype=np.float64)
        W = np.empty((A, F, s), dtype=np.float64)
        rc = lib.enet_cd_path(
            g.ctypes.data_as(ctypes.c_void_p),
            m.ctypes.data_as(ctypes.c_void_p),
            nt.ctypes.data_as(ctypes.c_void_p),
            F, s,
            al.ctypes.data_as(ctypes.c_void_p),
            A, float(l1r), int(max_iter), float(tol), 1,
            W.ctypes.data_as(ctypes.c_void_p))
        if rc == 0:
            return W
    W = np.empty((A, F, s), dtype=np.float64)
    for f in range(F):
        w = np.zeros(s)
        for ai, alpha in enumerate(alphas):
            w = _cd_gram(grams[f], moments[f], int(n_train[f]),
                         float(alpha), l1r, w, max_iter, tol,
                         positive=True)
            W[ai, f] = w
    return W


def lasso_mpm(alphas: np.ndarray, mse_path: np.ndarray) -> float:
    """One-SE 'mpm' alpha rule (identify_strains...sp.py:14-31): the
    sparsest alpha whose mean CV MSE is within one std of the minimum."""
    mse_mean = mse_path.mean(axis=1)
    mse_std = mse_path.std(axis=1)
    i_min = int(np.argmin(mse_mean))
    lo = mse_mean[i_min] - mse_std[i_min]
    hi = mse_mean[i_min] + mse_std[i_min]
    i_mpm = i_min
    for i in range(i_min - 1, -1, -1):
        if lo <= mse_mean[i] <= hi:
            i_mpm = i
    return float(alphas[i_mpm])


@dataclasses.dataclass
class EnetResult:
    coef: np.ndarray
    alpha: float
    alphas: np.ndarray
    mse_path: np.ndarray


def enet_cv_fit(X: np.ndarray, y: np.ndarray, device,
                cfg: IdentifyConfig = IdentifyConfig()) -> EnetResult:
    """ElasticNetCV + mpm rule + final ElasticNet fit (reference
    identify_strains...sp.py:431-456), fold Grams on ``device``."""
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n, s = X.shape
    l1r = cfg.enet_l1_ratio
    test_masks = shuffle_split_masks(n, cfg.enet_cv_niter,
                                     cfg.enet_test_size, cfg.enet_seed)
    train_masks = ~test_masks
    n_train = train_masks.sum(axis=1)
    # For 0/1 matrices (the only kind this pipeline produces) the
    # full-data Gram/moment ride along as an extra all-ones "fold" in
    # the SAME device pass — exact, so results are identical.  Non-binary
    # inputs keep the float64 host GEMMs for the full-data fit.
    binary = X.size == 0 or (X.min() >= 0 and X.max() <= 1
                             and np.array_equal(X, np.rint(X)))
    if binary:
        masks_ext = np.vstack([train_masks, np.ones((1, n), dtype=bool)])
        grams_ext, moments_ext = _fold_grams(
            X, y, masks_ext, device, min_shard_rows=cfg.shard_min_l2_rows)
        grams, gram_full = grams_ext[:-1], grams_ext[-1]
        moments, moment_full = moments_ext[:-1], moments_ext[-1]
    else:
        grams, moments = _fold_grams(X, y, train_masks, device)
        gram_full = X.T @ X
        moment_full = X.T @ y
    alphas = alpha_grid(X, y, l1r, cfg.enet_eps, cfg.enet_nalpha,
                        Xty=moment_full)
    W = _cd_path_all_folds(grams, moments, n_train, alphas, l1r,
                           cfg.enet_max_iter, cfg.enet_tol)
    # CV MSE from Gram quadratic forms: the test-fold moments are the
    # complements of the train-fold ones (every row is in exactly one of
    # the two), so mean((y_t - X_t w)^2) =
    # (||y_t||^2 - 2 w.b_t + w^T G_t w) / n_test with G_t = G - G_f,
    # b_t = b - b_f — no per-(alpha, fold) residual matvec over the
    # k-mer axis.
    yty_train = (y * y) @ train_masks.T.astype(np.float64)       # [F]
    yty_test = float(y @ y) - yty_train
    gt = gram_full[None] - grams                                 # [F, s, s]
    bt = moment_full[None] - moments                             # [F, s]
    n_test = (n - n_train).astype(np.float64)
    quad = np.einsum("afs,fst,aft->af", W, gt, W)
    lin = np.einsum("afs,fs->af", W, bt)
    mse_path = (yty_test[None] + quad - 2.0 * lin) / n_test[None]
    alpha_mpm = lasso_mpm(alphas, mse_path)
    coef = _cd_gram(gram_full, moment_full, n, alpha_mpm, l1r, np.zeros(s),
                    cfg.enet_max_iter, cfg.enet_tol, positive=True)
    return EnetResult(coef=coef, alpha=alpha_mpm, alphas=alphas,
                      mse_path=mse_path)
