"""The port's layer-2 math (fold Grams, Pre-Scan column sums, Elastic-Net,
detect_strains and the copied host helpers) against the JAX package's.

Tolerances: Grams, moments and column sums are exact integers (float64
sums of integer counts far below 2**53) and must be equal.  enet_cv_fit's
coef, alpha and mse_path must agree within rtol 1e-9, the bound the JAX
package holds against sklearn; in practice they are equal, since the
Grams are equal and the host solve is the same code.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from strainscan_tpu.config import IdentifyConfig
from strainscan_tpu.identify import prescan as jprescan
from strainscan_tpu.ops import enet as jenet
from strainscan_tpu_torch.identify import prescan
from strainscan_tpu_torch.ops import enet

from _torch_sim import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")


def _l2_problem(seed, n=3000, s=6):
    rng = np.random.default_rng(seed)
    X = (rng.random((n, s)) < 0.35).astype(np.int8)
    true = rng.random(s) * 6 * (rng.random(s) < 0.6)
    y = rng.poisson(X @ true + 0.2).astype(np.float64)
    return X, y


@pytest.mark.parametrize("seed", [0, 1])
def test_fold_grams_and_moments_exact(seed):
    X, y = _l2_problem(seed, n=2500 + 37 * seed)
    train = ~jenet.shuffle_split_masks(X.shape[0], 20, 0.5, 0)
    train = np.vstack([train, np.ones((1, X.shape[0]), bool)])
    g, m = enet._fold_grams(X.astype(np.float64), y, train, CPU, block=700)
    jg, jm = jenet._fold_grams(X.astype(np.float64), y, train)
    np.testing.assert_array_equal(g, jg)
    np.testing.assert_array_equal(m, jm)
    full = X.T.astype(np.float64) @ X
    np.testing.assert_array_equal(g[-1], full)


def test_enet_cv_fit_matches_jax():
    X, y = _l2_problem(3)
    cfg = IdentifyConfig()
    got = enet.enet_cv_fit(X, y, CPU, cfg)
    want = jenet.enet_cv_fit(X, y, cfg)
    np.testing.assert_allclose(got.coef, want.coef, rtol=1e-9, atol=0)
    np.testing.assert_allclose(got.mse_path, want.mse_path, rtol=1e-9)
    np.testing.assert_allclose(got.alphas, want.alphas, rtol=1e-9)
    assert got.alpha == pytest.approx(want.alpha, rel=1e-9)
    assert (got.coef > 0).sum() >= 2


def test_prescan_column_sums_exact():
    X, y = _l2_problem(4, n=2000, s=9)
    rng = np.random.default_rng(4)
    kern = prescan._L2Kernels(X, CPU)
    jkern = jprescan._L2Kernels(X)
    used = rng.random(X.shape[0]) < 0.3
    big = y > 1
    np.testing.assert_array_equal(kern.colsum(kern.to_mask(big)),
                                  np.asarray(jkern.colsum(jkern.to_mask(big))))
    got = kern.colsum_unused(kern.to_mask(used), kern.to_mask(big))
    want = jkern.colsum_unused(jnp.asarray(used), jkern.to_mask(big))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.dtype == np.int32
    u2 = kern.or_column(kern.to_mask(used), 3)
    np.testing.assert_array_equal(
        u2.numpy(), np.asarray(jkern.or_column(jnp.asarray(used), 3)))
    with pytest.raises(ValueError):
        prescan._L2Kernels(X * 2, CPU)


@pytest.mark.parametrize("l2,pmode,emode", [(0, 0, 0), (2, 0, 0), (0, 1, 0),
                                            (0, 0, 1)])
def test_detect_strains_matches_jax(l2, pmode, emode):
    X, y = _l2_problem(5, n=4000, s=5)
    py = y.copy()
    py[py == 1] = 0
    om = np.ones((X.shape[0], 1))
    sid = [f"S{i}" for i in range(X.shape[1])]
    npp_out = float(np.median(py[py != 0])) * 1000
    args = (X, py, sid, 31, 0.0, npp_out, npp_out, 0.9, om, l2, 1, pmode,
            emode)
    got = prescan.detect_strains(*args, CPU, IdentifyConfig())
    want = jprescan.detect_strains(*args, IdentifyConfig())
    assert repr(got) == repr(want)


def test_copied_host_helpers_equal():
    X, y = _l2_problem(6, n=500, s=4)
    Xf = X.astype(np.float64)
    np.testing.assert_array_equal(enet.shuffle_split_masks(97, 5, 0.5, 3),
                                  jenet.shuffle_split_masks(97, 5, 0.5, 3))
    np.testing.assert_array_equal(enet.alpha_grid(Xf, y, 0.5, 1e-3, 50),
                                  jenet.alpha_grid(Xf, y, 0.5, 1e-3, 50))
    g, b = Xf.T @ Xf, Xf.T @ y
    w = enet._cd_gram(g, b, 500, 0.01, 0.5, np.zeros(4), 5000, 1e-4, True)
    np.testing.assert_array_equal(
        w, jenet._cd_gram(g, b, 500, 0.01, 0.5, np.zeros(4), 5000, 1e-4,
                          True))
    grams = np.stack([g, g * 0.5])
    moms = np.stack([b, b * 0.5])
    alphas = enet.alpha_grid(Xf, y, 0.5, 1e-3, 10)
    np.testing.assert_array_equal(
        enet._cd_path_all_folds(grams, moms, np.array([500, 250]), alphas,
                                0.5, 5000, 1e-4),
        jenet._cd_path_all_folds(grams, moms, np.array([500, 250]), alphas,
                                 0.5, 5000, 1e-4))
    mse = np.random.default_rng(6).random((10, 5))
    assert enet.lasso_mpm(alphas, mse) == jenet.lasso_mpm(alphas, mse)
    assert prescan._optimize_dominant(X, y) == \
        jprescan._optimize_dominant(X, y)
    assert prescan._avg_depth(2, X, y) == jprescan._avg_depth(2, X, y)
