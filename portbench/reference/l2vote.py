"""The layer-2 vote and its reports, frozen copies.

Copies of ``strainscan_tpu_torch/ops/l2.py``, ``ops/enet.py`` (the Python
coordinate descent, not the native one), ``identify/prescan.py`` (one
device, no mesh) and ``identify/vote.py``, whose union count goes through
the reference's own table and count (:mod:`.fptable`) of the sample's code
reads.  Column sums and Grams are integer-exact in any order, so the
device these run on does not change a result.
"""

from __future__ import annotations

import dataclasses
import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.reference import fptable
from portbench.reference.config import IdentifyConfig
from portbench.reference.treedb import L2DB, load_l2_db, load_manifest


# rows per Gram block: bounds the [F, block, s] float64 weighted copy
GRAM_BLOCK = 16384


def masked_colsum(X: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """int32 ``[s]``: ``X^T mask`` for an int8 0/1 ``X [n, s]`` and a
    bool ``mask [n]``."""
    return (X * mask.to(torch.int8)[:, None]).sum(dim=0, dtype=torch.int32)


def fold_grams(X: torch.Tensor, T: torch.Tensor,
               block: int = GRAM_BLOCK) -> torch.Tensor:
    """float64 ``[F, s, s]``: ``X^T diag(T[f]) X`` for every fold ``f``,
    over row blocks, so memory is O(F * block * s).  ``X [n, s]`` and
    ``T [F, n]`` may be any real dtype; both are taken as float64."""
    n, s = X.shape
    grams = torch.zeros((T.shape[0], s, s), dtype=torch.float64,
                        device=X.device)
    for i in range(0, n, block):
        xb = X[i:i + block].to(torch.float64)                    # [b, s]
        tb = T[:, i:i + block].to(torch.float64)                 # [F, b]
        grams += torch.matmul((tb[:, :, None] * xb[None]).transpose(1, 2),
                              xb)
    return grams


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
                block: int = GRAM_BLOCK):
    """Per-fold Grams ``X^T diag(t_f) X`` and moments ``X^T (t_f * y)``.

    The Grams accumulate over row blocks on ``device`` in float64, so
    device memory is O(F * block * s) and the [F, n, s] fold-replicated
    design is never built.
    Moments are s-sized and computed on the host in float64, as in the JAX
    package.  Returns float64 NumPy arrays ``([F, s, s], [F, s])``."""
    n, s = X.shape
    F = train.shape[0]
    # one [F, n] @ [n, s] GEMM instead of F matvecs
    moments = (train * y).astype(np.float64) @ X.astype(np.float64)
    dev = torch.device(device)
    grams = fold_grams(torch.from_numpy(np.ascontiguousarray(X)).to(dev),
                          torch.from_numpy(np.ascontiguousarray(train)).to(dev),
                          block)
    return grams.cpu().numpy(), moments


def _cd_path_all_folds(grams: np.ndarray, moments: np.ndarray,
                       n_train: np.ndarray, alphas: np.ndarray, l1r: float,
                       max_iter: int, tol: float) -> np.ndarray:
    """W [A, F, s]: per-fold CD solutions along the alpha path.

    Each fold runs the SAME warm-started cyclic coordinate descent as
    :func:`_cd_gram` called alpha-by-alpha (the program runs the same
    descent in native code)."""
    F, s = moments.shape
    A = int(alphas.size)
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
            X, y, masks_ext, device)
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


def _optimize_dominant(X: np.ndarray, y: np.ndarray) -> int:
    """optimize_dominat_y (:136-175)."""
    s = X.shape[1]
    res = np.zeros(s)
    for c in range(s):
        da = X[:, c].astype(np.float64) * y
        da_noz = da[da != 0]
        if da_noz.size < 1 or np.sum(da_noz) == 0:
            res[c] = 0.0
            continue
        f25 = np.percentile(da_noz, 5, method="nearest")
        f75 = np.percentile(da_noz, 95, method="nearest")
        tem = y.copy().astype(np.float64)
        tem[tem < f25] = 0
        tem[tem > f75] = 0
        res[c] = float(X[:, c] @ tem)
    return int(np.where(res == res.max())[0][0])


def _avg_depth(dominant: int, X: np.ndarray, y: np.ndarray) -> float:
    """get_avg_depth (:110-120): IQR-trimmed mean of covered counts."""
    doarr = X[:, dominant].astype(np.float64) * y
    doarr = np.where(doarr == 1, 0, doarr)
    noz = doarr[doarr != 0]
    if noz.size == 0:
        return 0.0
    f25 = np.percentile(noz, 25, method="nearest")
    f75 = np.percentile(noz, 75, method="nearest")
    noz = noz.astype(np.float64)
    noz[noz < f25] = 0
    noz[noz > f75] = 0
    final = noz[noz != 0]
    return float(np.mean(final)) if final.size else 0.0


class _L2Kernels:
    """Pre-Scan linear algebra on ``device``.

    Everything the scan loop needs reduces to masked COLUMN SUMS of the
    0/1 k-mer x strain matrix — ``X^T m`` with a boolean row mask — plus
    an O(n) running ``used`` union.  X stays int8 on the device; a column
    sum is an int32 reduction of ``X * m``, exact and deterministic:

        get_candidate_arr (:121-134): count((npXt * y) > 1) per strain,
          where npXt = pXt_tem masked by ~used  ==  X^T (~used & (y > 1))
        get_remainc (:94-108): same with the pre-loop used vector
        cal_cov_all / stat_cov (:33-49): X^T (y > 1) over X's support

    The scan control flow (accept/reject, data-dependent exit) stays on
    the host, fetching one O(s) vector per round.
    """

    def __init__(self, X: np.ndarray, device):
        self.n, self.s = X.shape
        if X.size and (X.min() < 0 or X.max() > 1
                       or not np.array_equal(X, np.rint(X))):
            raise ValueError("Pre-Scan kernels require a 0/1 strain matrix")
        X8 = np.ascontiguousarray(X, dtype=np.int8)
        self.device = torch.device(device)
        self.Xd = torch.from_numpy(X8).to(self.device)

    def to_mask(self, m: np.ndarray):
        m = np.ascontiguousarray(m, dtype=bool)
        return torch.from_numpy(m).to(self.device)

    def colsum(self, mask) -> np.ndarray:
        """int32 [s]: per-strain count of set rows within X's support."""
        return masked_colsum(self.Xd, mask).cpu().numpy()

    def colsum_unused(self, used, big) -> np.ndarray:
        """int32 [s]: X^T (~used & big) — one fused reduction per round."""
        return self.colsum(~used & big)

    def or_column(self, used, c: int):
        """used |= X[:, c] (kept device-resident across scan rounds)."""
        return used | (self.Xd[:, c] > 0)


def detect_strains(
    X: np.ndarray,
    py: np.ndarray,
    sid: List[str],
    ksize: int,
    npp25: float,
    npp75: float,
    npp_out: float,
    cls_cov: float,
    om_selected: np.ndarray,
    l2: int,
    msn: int,
    pmode: int,
    emode: int,
    device,
    cfg: IdentifyConfig = IdentifyConfig(),
):
    """detect_strains (:177-478).

    Args mirror the reference: X is the dense k-mer × strain matrix, py the
    per-k-mer counts (1-counts already zeroed), om_selected the overlap
    matrix restricted to the detected clusters' columns.
    """
    # X stays int8 end to end; column products cast on demand
    X = np.asarray(X)
    py = np.asarray(py, dtype=np.float64)
    ln = om_selected.sum(axis=1).astype(np.float64)
    ln[ln > 1] = 0
    py_u = py * ln

    cutoff = msn * ksize
    # X is the 0/1 strain matrix (all_strains_re), so every Pre-Scan
    # statistic reduces to exact integer column sums (see _L2Kernels)
    kern = _L2Kernels(X, device)
    totals = kern.colsum(kern.to_mask(np.ones(X.shape[0], dtype=bool)))
    big_py = py > 1
    valid_all = kern.colsum(kern.to_mask(big_py))
    with np.errstate(divide="ignore", invalid="ignore"):
        cov_arr = np.where(totals > 0, valid_all / np.maximum(totals, 1),
                           0.0)

    def stat_cov_i(i):
        t = int(totals[i])
        v = int(valid_all[i])
        return (v / t if t else 0.0, v, t)

    dominant_avg_depth = 0.0
    default_cov = 0.0 if (pmode == 1 or emode == 1) else cfg.prescan_default_cov
    # gate_float mirrors the reference's dtype flow: when the coverage
    # gate applies, pXt_tem = pXt * float mask makes the candidate
    # ``check`` a float (printed "8674.0" in StrainVote.report); in the
    # ungated else branch it stays int (identify_strains...sp.py:256-262,
    # get_candidate_arr :121-134)
    gate_float = bool(np.max(cov_arr) > default_cov)
    if gate_float:
        gate = (cov_arr > default_cov).astype(np.float64)
    else:
        gate = np.ones(X.shape[1])
        if np.max(cov_arr) < 0.01:
            l2 = 2

    if l2 == 2:
        dominant = int(np.where(cov_arr == cov_arr.max())[0][0])
        dominant_avg_depth = _avg_depth(
            dominant, X, py_u if py_u.sum() > 0 else py)
    else:
        yy = py_u if py_u.sum() > 0 else py
        dominant = _optimize_dominant(X, yy)
        dominant_avg_depth = _avg_depth(dominant, X, yy)

    out_columns = [dominant]
    out_strains = [sid[dominant]]
    strain_cov: Dict[str, Tuple[float, int, int]] = {}
    strain_val: Dict[str, int] = {}
    final_src: Dict[str, float] = {}
    strain_cov[sid[dominant]] = stat_cov_i(dominant)
    strain_val[sid[dominant]] = strain_cov[sid[dominant]][1]
    final_src[sid[dominant]] = strain_cov[sid[dominant]][0]

    # stale remain-coverage, computed once (get_remainc, :94-108 at :316):
    # npXt0[i] = pXt_tem[i] & ~used, so all_k = gate * X^T(~used) and the
    # covered count = gate * X^T(~used & (py_u > 1))
    used = kern.to_mask(X[:, dominant] > 0)
    big_pyu = kern.to_mask(big_py & (ln > 0))
    all_ones = kern.to_mask(np.ones(X.shape[0], dtype=bool))
    all_k = gate * kern.colsum_unused(used, all_ones)
    chk = gate * kern.colsum_unused(used, big_pyu)
    with np.errstate(divide="ignore", invalid="ignore"):
        strain_remainc = np.where(all_k > 0, chk / np.maximum(all_k, 1), 0.0)
    strain_remainc[dominant] = strain_cov[sid[dominant]][0]

    big_yy = big_pyu if py_u.sum() > 0 else kern.to_mask(big_py)
    remainc_cutoff = 0.0 if emode == 1 else cfg.prescan_remainc
    check_c = cfg.emode_check_c if emode == 1 else cutoff
    for _ in range(cfg.prescan_max_iter):
        # get_candidate_arr (:121-134): one fused reduction per round
        checks = gate * kern.colsum_unused(used, big_yy)
        cand = int(np.argmax(checks))
        check = int(checks[cand])
        if check >= check_c:
            if strain_remainc[cand] > remainc_cutoff:
                out_columns.append(cand)
                out_strains.append(sid[cand])
                strain_cov[sid[cand]] = stat_cov_i(cand)
                strain_val[sid[cand]] = float(check) if gate_float else check
                final_src[sid[cand]] = strain_remainc[cand]
            used = kern.or_column(used, cand)
        else:
            break

    if len(out_columns) == 1:
        res = {out_strains[0]: 1}
        res2 = {out_strains[0]: dominant_avg_depth}
        return res, res2, strain_cov, strain_val, final_src

    # -------------------- Elastic-Net over selected columns (:399-456)
    oX = X[:, out_columns]
    keep = ~((py < npp25) | (py > npp75) | (py > npp_out))
    Xf = oX[keep]
    yf = py[keep]
    result = enet_cv_fit(Xf, yf, device, cfg)
    coef = np.atleast_1d(result.coef)
    if coef.sum() != 0:
        norm = coef / coef.sum()
        res = dict(zip(out_strains, norm.tolist()))
        res2 = dict(zip(out_strains, coef.tolist()))
    else:
        res, res2 = {}, {}
    return res, res2, strain_cov, strain_val, final_src


def check_l1_res(res: Dict[int, dict]) -> bool:
    """True when every detected cluster resolved to a single strain
    (check_L1_res, :68-74)."""
    return all(res[r]["strain"] != 0 for r in res)


def generate_single_report(res: Dict[int, dict], out_dir: str) -> None:
    """:232-244."""
    os.makedirs(out_dir, exist_ok=True)
    rows = sorted(res.items(), key=lambda kv: kv[1]["cls_per"], reverse=True)
    with open(os.path.join(out_dir, "final_report.txt"), "w") as o:
        o.write("Strain_ID\tStrain_Name\tCluster_ID\tRelative_Abundance_"
                "Inside_Cluster\tPredicted_Depth\tCoverage\tCovered/"
                "Total_kmr\n")
        for c, (cid, info) in enumerate(rows, 1):
            o.write(f"{c}\t{info['strain']}\tC{cid}\t{info['cls_per']}\t"
                    f"{info['cls_ab']}\t{info['cls_cov']}\t"
                    f"{info['cls_covered_num']}/{info['cls_total_num']}\n")


def _write_strain_vote_report(
    out_path: str, cls: str, nr, res2, strain_cov, strain_val, final_src,
    cls_ab: float, cfg: IdentifyConfig, emode: int,
) -> None:
    """:420-438 — identical column layout, '*' under the CV header."""
    tdep = sum(res2[n] for n, _ in nr)
    with open(out_path, "w") as o:
        o.write("Strain_ID\tStrain_Name\tCluster_ID\tRelative_Abundance_"
                "Inside_Cluster\tPredicted_Depth (Enet)\tPredicted_Depth "
                "(Ab*cls_depth)\tCoverage\tCoverd/Total_kmr\tValid_kmr\t"
                "Remain_Coverage\tCV\tExist_Evidence\n")
        for c, (name, relab) in enumerate(nr, 1):
            pda = (res2[name] / tdep) * cls_ab if tdep else 0.0
            cov, valid, total = strain_cov[name]
            base = (f"{c}\t{{name}}\t{cls}\t{relab}\t{res2[name]}\t{pda}\t"
                    f"{cov}\t{valid}/{total}\t{strain_val[name]}\t"
                    f"{final_src[name]}\t")
            if relab > cfg.exist_relab and cov > cfg.exist_cov:
                o.write(base.format(name=name) + "*\n")
            elif emode == 1:
                o.write(base.format(
                    name=f"{name} (With_ExtraRegion_covered)") + "\n")
            else:
                o.write(base.format(name=name) + "\n")


def merge_res(out_dir: str, res: Dict[int, dict]) -> None:
    """Merge per-cluster reports into final_report.txt (:116-170)."""
    dinfo: Dict[str, dict] = defaultdict(dict)
    total_depth = 0.0
    for r in res:
        if res[r]["strain"] != 0:
            total_depth += float(res[r]["s_ab"])
            d = dinfo[res[r]["strain"]]
            d["cid"] = f"C{r}"
            d["pde"] = "NA"
            d["pda"] = float(res[r]["s_ab"])
            d["cov"] = res[r]["cls_cov"]
            d["ct"] = f"{res[r]['cls_covered_num']}/{res[r]['cls_total_num']}"
        else:
            rep = os.path.join(out_dir, f"C{r}", "StrainVote.report")
            if not os.path.exists(rep):
                continue
            total_pda = 0.0
            total_pde = 0.0
            tem = []
            with open(rep) as f:
                f.readline()
                for line in f:
                    ele = line.rstrip("\n").split("\t")
                    if len(ele) < 8:
                        continue
                    total_pda += float(ele[5])
                    total_pde += float(ele[4])
                    d = dinfo[ele[1]]
                    d["cid"] = ele[2]
                    d["pde"] = ele[4]
                    d["pda"] = float(ele[5])
                    d["cov"] = ele[6]
                    d["ct"] = ele[7]
                    tem.append(ele[1])
            if len(tem) == 1:
                total_depth += total_pde
                dinfo[tem[0]]["pda"] = float(dinfo[tem[0]]["pde"])
            else:
                total_depth += total_pda
    dab = {s: (dinfo[s]["pda"] / total_depth if total_depth else 0.0)
           for s in dinfo}
    with open(os.path.join(out_dir, "final_report.txt"), "w") as o:
        o.write("ID\tStrain_Name\tCluster_ID\tRelative_Abundance\t"
                "Predicted_Depth (Enet)\tPredicted_Depth (Ab*cls_depth)\t"
                "Coverage\tCoverd/Total_kmr\n")
        for c, (s, ab) in enumerate(
                sorted(dab.items(), key=lambda kv: kv[1], reverse=True), 1):
            d = dinfo[s]
            o.write(f"{c}\t{s}\t{d['cid']}\t{ab}\t{d['pde']}\t{d['pda']}\t"
                    f"{d['cov']}\t{d['ct']}\n")


def _count_union(clusters: List[L2DB], reads: np.ndarray, k: int,
                 device, fp_bits: int) -> Dict[int, np.ndarray]:
    """One count of the sample against the union of the clusters' k-mers,
    through the reference's own table of the union."""
    union = np.unique(np.concatenate([cl.kmers for cl in clusters]))
    table = fptable.build(fptable.keys_tensor(union, device))
    if fp_bits < 32:
        table = fptable.narrowed(table, fp_bits)
    counts = fptable.count(table, reads, device, k=k)
    out = {}
    for cl in clusters:
        idx = np.searchsorted(union, cl.kmers)
        out[cl.cid] = counts[idx]
    return out


def vote_strain_l2(
    cl: L2DB,
    counts: np.ndarray,
    out_dir: str,
    res: Dict[int, dict],
    l2: int,
    cfg: IdentifyConfig,
    device,
    k: int,
    pmode: int = 0,
    emode: int = 0,
    cluster_ids: Optional[Sequence[int]] = None,
) -> None:
    """Per-cluster detection + report (vote_strain_L2, :334-438)."""
    cls = f"C{cl.cid}"
    cls_out = os.path.join(out_dir, cls)
    os.makedirs(cls_out, exist_ok=True)
    cls_ab = res[cl.cid]["cls_ab"]
    cls_cov = res[cl.cid]["cls_cov"]
    py = counts.astype(np.int64).copy()
    py[py == 1] = 0                      # remove_1 (:312-322)
    npp = py[py != 0]
    if npp.size == 0:
        return
    npp_outlier = float(np.median(npp)) * cfg.l2_outlier_factor  # :409
    npp25, npp75 = 0.0, npp_outlier
    # overlap columns for the detected clusters (:181-196)
    if cluster_ids is None:
        cluster_ids = list(range(1, cl.overlap.shape[1] + 1))
    col_of = {cid: i for i, cid in enumerate(cluster_ids)}
    sel = [col_of[c] for c in res if c in col_of]
    om_sel = np.asarray(cl.overlap[:, sel].todense())
    # int8 dense, cached on the (LRU-cached) L2DB
    X = cl.dense8()
    out = detect_strains(
        X, py, cl.strains, k, npp25, npp75, npp_outlier, cls_cov,
        om_sel, l2, cfg.min_snv_num, pmode, emode, device, cfg)
    res_d, res2, strain_cov, strain_val, final_src = out
    if not res_d:
        return
    nr = sorted(res_d.items(), key=lambda kv: kv[1], reverse=True)
    _write_strain_vote_report(
        os.path.join(cls_out, "StrainVote.report"), cls, nr, res2,
        strain_cov, strain_val, final_src, cls_ab, cfg, emode)


def vote_strain_l2_batch(
    reads: np.ndarray,
    db_dir: str,
    out_dir: str,
    res: Dict[int, dict],
    l2: int,
    device,
    k: int,
    cfg: IdentifyConfig = IdentifyConfig(),
    pmode: int = 0,
    emode: int = 0,
    fp_bits: int = 32,
    log=lambda m: None,
) -> None:
    """vote_strain_L2_batch (:247-311)."""
    os.makedirs(out_dir, exist_ok=True)
    if check_l1_res(res):
        log("only single-strain clusters identified; skipping layer 2")
        generate_single_report(res, out_dir)
        return
    multi = [r for r in res if res[r]["strain"] == 0]
    clusters: List[L2DB] = []
    for r in multi:
        cl = load_l2_db(db_dir, r)
        if cl is None:
            log(f"warning: no L2 data for cluster {r}")
            continue
        clusters.append(cl)
    if not clusters:
        generate_single_report(res, out_dir)
        return
    manifest = load_manifest(db_dir)
    counts_by_cid = _count_union(clusters, reads, k, device, fp_bits)
    cluster_ids = manifest.get("cluster_ids")
    for cl in clusters:
        log(f"layer-2 identification for cluster C{cl.cid}")
        vote_strain_l2(cl, counts_by_cid[cl.cid], out_dir, res, l2, cfg,
                       device, k, pmode, emode, cluster_ids)
    if len(res) == 1:
        # single multi-strain cluster: its report IS the final report (:258-273)
        only = clusters[0].cid
        rep = os.path.join(out_dir, f"C{only}", "StrainVote.report")
        if os.path.exists(rep):
            with open(rep) as f, open(
                    os.path.join(out_dir, "final_report.txt"), "w") as o:
                o.write(f.read())
    else:
        log("merging cluster reports")
        merge_res(out_dir, res)
