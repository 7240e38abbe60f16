"""Layer-2 strain detection: iterative Pre-Scan + positive Elastic-Net.

Port of ``strainscan_tpu/identify/prescan.py`` (itself a port of the
reference library/identify_strains_L2_Enet_Pscan_new_sp.py:177-478).  The
host helpers and ``detect_strains`` are copies; the Pre-Scan column sums
(:class:`_L2Kernels`) run as int32 masked reductions over the int8 0/1
k-mer x strain matrix on ``device``, and the Elastic-Net fold Grams run on
``device`` through :func:`..ops.enet.enet_cv_fit`.  With a mesh of several
positions and at least ``cfg.shard_min_l2_rows`` rows, both split the
k-mer axis over the mesh (``parallel.sharded``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from strainscan_tpu.config import IdentifyConfig
from strainscan_tpu_torch.ops import enet, l2
from strainscan_tpu_torch.parallel import sharded as psh
from strainscan_tpu_torch.timing import phase_acc


def _stat_cov(col: np.ndarray, y: np.ndarray) -> Tuple[float, int, int]:
    """stat_cov (:33-43): coverage counting products > 1 as covered."""
    total = int(np.count_nonzero(col))
    ic = col * y
    valid = int(np.count_nonzero(ic > 1))
    cov = valid / total if total else 0.0
    return cov, valid, total


def _cal_cov_all(X: np.ndarray, y: np.ndarray) -> np.ndarray:
    """cal_cov_all (:44-49) vectorized: per-strain coverage."""
    totals = (X != 0).sum(axis=0)
    valid = ((X * y[:, None]) > 1).sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        cov = np.where(totals > 0, valid / np.maximum(totals, 1), 0.0)
    return cov


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


def _candidate(npXt: np.ndarray, y: np.ndarray) -> Tuple[int, int]:
    """get_candidate_arr (:121-134): most remaining covered k-mers."""
    prod = npXt * y[None, :]
    checks = (prod > 1).sum(axis=1)
    cand = int(np.argmax(checks))
    return cand, int(checks[cand])


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

    With ``min_shard_rows`` set and ``l2_mesh`` granting a mesh, X and
    every mask are split by rows over the mesh's positions (padded with
    zero rows) and each column sum is the sum of per-position partials.
    The scan control flow (accept/reject, data-dependent exit) stays on
    the host, fetching one O(s) vector per round.
    """

    def __init__(self, X: np.ndarray, device,
                 min_shard_rows: Optional[int] = None):
        self.n, self.s = X.shape
        if X.size and (X.min() < 0 or X.max() > 1
                       or not np.array_equal(X, np.rint(X))):
            raise ValueError("Pre-Scan kernels require a 0/1 strain matrix")
        X8 = np.ascontiguousarray(X, dtype=np.int8)
        mesh = psh.resolve_mesh(device)
        self.device = mesh.first
        self.mesh = (psh.l2_mesh(mesh, self.n, min_shard_rows)
                     if min_shard_rows is not None else None)
        self._pad = 0
        if self.mesh is not None:
            self._pad = psh.pad_rows(self.mesh, self.n) - self.n
            self.Xd = psh.shard_rows(self.mesh, np.pad(X8, ((0, self._pad),
                                                            (0, 0))))
        else:
            self.Xd = torch.from_numpy(X8).to(self.device)

    def to_mask(self, m: np.ndarray):
        m = np.ascontiguousarray(m, dtype=bool)
        if self.mesh is not None:
            return psh.shard_rows(self.mesh, np.pad(m, (0, self._pad)))
        return torch.from_numpy(m).to(self.device)

    def colsum(self, mask) -> np.ndarray:
        """int32 [s]: per-strain count of set rows within X's support."""
        if self.mesh is not None:
            return psh.sharded_colsum(self.mesh, self.Xd, mask)
        return l2.masked_colsum(self.Xd, mask).cpu().numpy()

    def colsum_unused(self, used, big) -> np.ndarray:
        """int32 [s]: X^T (~used & big) — one fused reduction per round."""
        if self.mesh is not None:
            return psh.sharded_colsum_unused(self.mesh, self.Xd, used, big)
        return self.colsum(~used & big)

    def or_column(self, used, c: int):
        """used |= X[:, c] (kept device-resident across scan rounds)."""
        if self.mesh is not None:
            return psh.sharded_or_col(self.mesh, used, self.Xd, c)
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
    kern = _L2Kernels(X, device, min_shard_rows=cfg.shard_min_l2_rows)
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
        with phase_acc("l2/optimize_dominant"):
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
    with phase_acc("l2/enet_cv_fit"):
        result = enet.enet_cv_fit(Xf, yf, device, cfg)
    coef = np.atleast_1d(result.coef)
    if coef.sum() != 0:
        norm = coef / coef.sum()
        res = dict(zip(out_strains, norm.tolist()))
        res2 = dict(zip(out_strains, coef.tolist()))
    else:
        res, res2 = {}, {}
    return res, res2, strain_cov, strain_val, final_src
