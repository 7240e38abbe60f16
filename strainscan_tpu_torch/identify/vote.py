"""Layer-2 orchestration and reports.

Port of ``strainscan_tpu/identify/vote.py`` (reference
library/Vote_Strain_L2_Lasso_new_sp.py:247-438).  The report writers are
copies; the sample is counted ONCE against a union table of all detected
multi-strain clusters' k-mers, and per-cluster count vectors are sliced out
of the combined result.  The union count is one ``count_sample`` of the
sample's ``SampleReads``, on its device or mesh, which reads the device
payloads that the main count kept where it can, else streams the sample
again.  Unlike the JAX package, the union is not padded with unreachable
keys: that pad only bounded the number of compiled shapes, and pad keys
never match a window, so counts are unchanged.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from strainscan_tpu_torch.build.db import L2DB, load_l2_db, load_manifest
from strainscan_tpu_torch.config import IdentifyConfig
from strainscan_tpu_torch.identify import prescan
from strainscan_tpu_torch.identify.count import SampleReads, count_sample
from strainscan_tpu_torch.index.hashtable import FpTable
from strainscan_tpu_torch.timing import phase


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


def _count_union(clusters: List[L2DB], reads: SampleReads,
                 canonical: bool) -> Dict[int, np.ndarray]:
    """One count of the sample for all clusters' k-mers, the phase
    ``identify/l2_vote/union_count``."""
    with phase("identify/l2_vote/union_count"):
        union = np.unique(np.concatenate([cl.kmers for cl in clusters]))
        fpt = FpTable.build(union, k=clusters[0].table.k)
        counts = count_sample(fpt, reads, reads.device, canonical=canonical,
                              keys=union)
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
    # int8 dense and its device copy, both cached on the (LRU-cached) L2DB
    X = cl.dense8()
    out = prescan.detect_strains(
        X, py, cl.strains, cl.table.k, npp25, npp75, npp_outlier, cls_cov,
        om_sel, l2, cfg.min_snv_num, pmode, emode, device, cfg,
        prescan.cluster_kernels(cl, device, cfg))
    res_d, res2, strain_cov, strain_val, final_src = out
    if not res_d:
        return
    nr = sorted(res_d.items(), key=lambda kv: kv[1], reverse=True)
    _write_strain_vote_report(
        os.path.join(cls_out, "StrainVote.report"), cls, nr, res2,
        strain_cov, strain_val, final_src, cls_ab, cfg, emode)


def vote_strain_l2_batch(
    reads: SampleReads,
    db_dir: str,
    out_dir: str,
    res: Dict[int, dict],
    l2: int,
    cfg: IdentifyConfig = IdentifyConfig(),
    pmode: int = 0,
    emode: int = 0,
    canonical: bool = False,
    log=lambda m: None,
) -> None:
    """vote_strain_L2_batch (:247-311): the sample's ``reads`` are
    counted once for every voted cluster (:func:`_count_union`) and voted
    on their device."""
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
    counts_by_cid = _count_union(clusters, reads, canonical)
    cluster_ids = manifest.get("cluster_ids")
    for cl in clusters:
        log(f"layer-2 identification for cluster C{cl.cid}")
        vote_strain_l2(cl, counts_by_cid[cl.cid], out_dir, res, l2, cfg,
                       reads.device, pmode, emode, cluster_ids)
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
