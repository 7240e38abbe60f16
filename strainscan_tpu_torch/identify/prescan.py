"""Layer-2 strain detection: iterative Pre-Scan + positive Elastic-Net.

Port of ``strainscan_tpu/identify/prescan.py`` (itself a port of the
reference library/identify_strains_L2_Enet_Pscan_new_sp.py:177-478).  The
host helpers and ``detect_strains`` are copies; the Pre-Scan column sums
(:class:`_L2Kernels`) run as int32 masked reductions over the int8 0/1
k-mer x strain matrix on ``device``, the dominant search
(:func:`_optimize_dominant`) is one pass over all its columns there, and
the Elastic-Net fold Grams run on ``device`` through
:func:`..ops.enet.enet_cv_fit`.  With a mesh of several positions and at
least ``cfg.shard_min_l2_rows`` rows, the column sums and the Grams split
the k-mer axis over the mesh (``parallel.sharded``); the dominant search
runs on the mesh's first device with the whole matrix.

A loaded cluster's matrix is checked as 0/1 and uploaded once
(:func:`cluster_kernels`); a sample uploads only its masks and counts.
The phases ``identify/l2_vote/prescan`` (up to the Elastic-Net), its
``identify/l2_vote/prescan/dominant`` and ``identify/l2_vote/enet`` add
their seconds per cluster to ``timing.PHASE_TIMES``; :data:`L2STATS`
counts the latest sample's clusters, matrix shapes, scan rounds, uploads
and checks.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from strainscan_tpu_torch.config import IdentifyConfig
from strainscan_tpu_torch.ops import enet, l2
from strainscan_tpu_torch.parallel import sharded as psh
from strainscan_tpu_torch.timing import phase


# the latest sample's Pre-Scan: multi-strain clusters voted, each strain
# matrix's [rows, columns], scan rounds, and matrix uploads and 0/1 checks
# (one each per loaded cluster, none on its later samples); run_identify
# resets it at each sample's start, as reset_l2stats does
L2STATS = {"clusters": 0, "shapes": [], "rounds": 0, "uploads": 0,
           "checks": 0}


def reset_l2stats() -> None:
    L2STATS.update(clusters=0, shapes=[], rounds=0, uploads=0, checks=0)


def _nearest_rank(n: torch.Tensor, q: float) -> torch.Tensor:
    """The index ``np.percentile(a, q, method="nearest")`` takes into ``n``
    sorted values, per entry of ``n``: ``(n - 1) * (q / 100)`` in float64,
    rounded half to even (0 for ``n == 0``)."""
    return torch.round((n - 1).to(torch.float64) * (q / 100)).clamp(
        min=0).to(torch.int64)


def _optimize_dominant(X, y: np.ndarray) -> int:
    """optimize_dominat_y (:136-175): the first column of the highest
    :func:`_dominant_scores`."""
    res = _dominant_scores(X, y)
    return int(np.where(res == res.max())[0][0])


def _dominant_scores(X, y: np.ndarray) -> np.ndarray:
    """float64 ``[s]``: optimize_dominat_y's score of every column at once,
    on the device of ``X`` (an int8 0/1 tensor, or an array taken as one
    on the CPU).

    The reference scores column ``c`` by the sum of ``y`` over the rows of
    ``c`` with ``f5 <= y <= f95``, where ``f5`` and ``f95`` are the
    nearest-rank 5th and 95th percentiles of the column's nonzero products
    ``X[:, c] * y`` (0 for a column with none, or whose products sum to 0),
    and the first maximum wins.  Here the rows are sorted by ``y`` once:
    a column's ``j``-th smallest nonzero product is the ``y`` of the row
    where its running count of set rows with ``y != 0`` reaches ``j + 1``,
    and its score is the difference of its running sums of ``y`` at the
    ends of the rows with ``f5 <= y <= f95``.  The counts are integers and
    ``y`` holds integer counts, so every score is exact."""
    Xd = torch.as_tensor(X)
    n, s = Xd.shape
    if n == 0:
        return np.zeros(s)
    yd = torch.from_numpy(np.ascontiguousarray(y, dtype=np.float64)).to(
        Xd.device)
    order = torch.argsort(yd)
    ys = yd[order]
    Xt = Xd.index_select(0, order).t().contiguous()          # [s, n] int8
    # running count of each column's nonzero products, in y order
    cnt = torch.cumsum(Xt * (ys != 0).to(torch.int8), dim=1,
                       dtype=torch.int32)
    nnz = cnt[:, -1]
    ranks = torch.stack([_nearest_rank(nnz, 5), _nearest_rank(nnz, 95)], 1)
    at = torch.searchsorted(cnt, (ranks + 1).to(torch.int32))
    f = ys[at.clamp(max=n - 1)]                              # [s, 2]
    lo = torch.searchsorted(ys, f[:, 0].contiguous())
    hi = torch.searchsorted(ys, f[:, 1].contiguous(), right=True)
    run = torch.cumsum(Xt * ys, dim=1)                       # [s, n] float64

    def upto(i):
        """Per column, the sum of its products over the first ``i`` rows."""
        got = run.gather(1, (i - 1).clamp(min=0)[:, None])[:, 0]
        return torch.where(i > 0, got, torch.zeros_like(got))

    score = upto(hi) - upto(lo)
    score = torch.where((nnz > 0) & (run[:, -1] != 0), score,
                        torch.zeros_like(score))
    return score.cpu().numpy()


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

    With ``min_shard_rows`` set and ``l2_mesh`` granting a mesh, X and
    every mask are split by rows over the mesh's positions (padded with
    zero rows) and each column sum is the sum of per-position partials.
    The scan control flow (accept/reject, data-dependent exit) stays on
    the host, fetching one O(s) vector per round.  Building one checks X
    as 0/1 and uploads it (each counted in :data:`L2STATS`).
    """

    def __init__(self, X: np.ndarray, device,
                 min_shard_rows: Optional[int] = None):
        self.n, self.s = X.shape
        L2STATS["checks"] += 1
        if X.size and (X.min() < 0 or X.max() > 1
                       or not np.array_equal(X, np.rint(X))):
            raise ValueError("Pre-Scan kernels require a 0/1 strain matrix")
        X8 = np.ascontiguousarray(X, dtype=np.int8)
        L2STATS["uploads"] += 1
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
        self._whole = None

    def whole(self) -> torch.Tensor:
        """X ``[n, s]`` on the first device: the single-device matrix, or
        the mesh's shards gathered there once."""
        if self.mesh is None:
            return self.Xd
        if self._whole is None:
            self._whole = torch.cat([x.to(self.device) for x in self.Xd]
                                    )[:self.n]
        return self._whole

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


def cluster_kernels(cl, device,
                    cfg: IdentifyConfig = IdentifyConfig()) -> _L2Kernels:
    """The Pre-Scan kernels of a loaded cluster ``cl`` (a ``build.db.L2DB``)
    on ``device``: its matrix ``cl.dense8()`` checked and uploaded by the
    first call, then kept on ``cl`` beside it for every later sample (as
    long as the L2 DB cache holds ``cl``)."""
    mesh = psh.resolve_mesh(device)
    key = (mesh.grid, cfg.shard_min_l2_rows)
    cache = getattr(cl, "_kernels", None)
    if cache is None:
        cache = {}
        object.__setattr__(cl, "_kernels", cache)
    if key not in cache:
        cache[key] = _L2Kernels(cl.dense8(), mesh, cfg.shard_min_l2_rows)
    return cache[key]


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
    kern: Optional[_L2Kernels] = None,
):
    """detect_strains (:177-478).

    Args mirror the reference: X is the dense k-mer × strain matrix, py the
    per-k-mer counts (1-counts already zeroed), om_selected the overlap
    matrix restricted to the detected clusters' columns.  ``kern`` holds X
    on ``device`` already (:func:`cluster_kernels`); without it X is
    checked and uploaded for this call.
    """
    # X stays int8 end to end; column products cast on demand
    X = np.asarray(X)
    py = np.asarray(py, dtype=np.float64)
    L2STATS["clusters"] += 1
    L2STATS["shapes"].append(list(X.shape))
    with phase("identify/l2_vote/prescan", acc=True):
        found = _prescan(X, py, sid, ksize, cls_cov, om_selected, l2, msn,
                         pmode, emode, device, cfg, kern)
    out_columns, out_strains, strain_cov, strain_val, final_src, depth = \
        found
    if len(out_columns) == 1:
        res = {out_strains[0]: 1}
        res2 = {out_strains[0]: depth}
        return res, res2, strain_cov, strain_val, final_src

    # -------------------- Elastic-Net over selected columns (:399-456)
    with phase("identify/l2_vote/enet", acc=True):
        oX = X[:, out_columns]
        keep = ~((py < npp25) | (py > npp75) | (py > npp_out))
        Xf = oX[keep]
        yf = py[keep]
        result = enet.enet_cv_fit(Xf, yf, device, cfg)
    coef = np.atleast_1d(result.coef)
    if coef.sum() != 0:
        norm = coef / coef.sum()
        res = dict(zip(out_strains, norm.tolist()))
        res2 = dict(zip(out_strains, coef.tolist()))
    else:
        res, res2 = {}, {}
    return res, res2, strain_cov, strain_val, final_src


def _prescan(X, py, sid, ksize, cls_cov, om_selected, l2, msn, pmode, emode,
             device, cfg, kern):
    """The Pre-Scan of :func:`detect_strains`, up to the Elastic-Net:
    ``(out_columns, out_strains, strain_cov, strain_val, final_src,
    dominant_avg_depth)``."""
    ln = om_selected.sum(axis=1).astype(np.float64)
    ln[ln > 1] = 0
    py_u = py * ln

    cutoff = msn * ksize
    # X is the 0/1 strain matrix (all_strains_re), so every Pre-Scan
    # statistic reduces to exact integer column sums (see _L2Kernels)
    if kern is None:
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

    with phase("identify/l2_vote/prescan/dominant", acc=True):
        if l2 == 2:
            dominant = int(np.where(cov_arr == cov_arr.max())[0][0])
            dominant_avg_depth = _avg_depth(
                dominant, X, py_u if py_u.sum() > 0 else py)
        else:
            yy = py_u if py_u.sum() > 0 else py
            dominant = _optimize_dominant(kern.whole(), yy)
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
        L2STATS["rounds"] += 1
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
    return (out_columns, out_strains, strain_cov, strain_val, final_src,
            dominant_avg_depth)
