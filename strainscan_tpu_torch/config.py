"""Centralized configuration for StrainScan-TPU.

The reference scatters critical constants across modules (see survey:
cutoff ladders at StrainScan.py:194-217, node-size classes at
identify.py:52-61, binomial parameters at identify.py:356-357,
exist-evidence thresholds at Vote_Strain_L2_Lasso_new_sp.py:431, Pre-Scan
limits at identify_strains_L2_Enet_Pscan_new_sp.py:318-371, Enet CV grid at
:433-437, and build caps at StrainScan_build.py:53-80).  Here every tunable
lives in one typed place.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class BuildConfig:
    """DB-build parameters (reference: StrainScan_build.py:53-80 defaults)."""

    ksize: int = 31                 # -k; k-mer size (odd)
    threads: int = 1                # -t; host-side parallel workers
    uk_num: int = 100_000           # -u; max unique k-mers kept per genome
    gk_ratio: float = 1.0           # -g; fraction of group-specific k-mers kept
    memory_efficient: bool = False  # -e; canonical-only (half-size) DB
    min_kmer: int = 1000            # -n; min k-mers per CST node
    max_kmer: int = 30_000          # -x; max k-mers per CST node (down-sample)
    max_cls_recon: int = 3000       # -r; max cluster count for node reconstruction
    # primary clustering: single linkage, distance cutoff 0.05 == 95% identity
    # (reference StrainScan_build.py:109)
    cls_method: str = "single"
    cls_cutoff: float = 0.05
    # core-threshold alpha: a k-mer is "core" (Lv) for a leaf when it appears
    # in >= alpha_ratio * n_genomes of the leaf's genomes (Build_tree.py:123-128)
    alpha_ratio: float = 0.8
    # L2 dedup: complete linkage at Hamming-fraction 0.01 (Recls_withR_new.py:38)
    recls_cutoff: float = 0.01
    # distance estimation: number of bottom-k minhash sketch values per genome
    # (replaces the dashing HyperLogLog sketch, Cluster.py:24-26)
    sketch_size: int = 8192
    exact_distance: bool = False    # use exact Jaccard instead of minhash
    seed: int = 0                   # down-sampling RNG seed (deterministic builds)


@dataclasses.dataclass(frozen=True)
class IdentifyConfig:
    """Identification parameters (reference: StrainScan.py:116-171 defaults)."""

    ksize: int = 31
    low_dep: int = 0          # -l; 0 / 1 (<10x) / 2 (<1x)
    strain_prob: bool = False  # -b; low-depth probability report
    plasmid_mode: int = 0     # -p; 0 / 1 (short contigs) / 2 (given refs)
    extra_region: bool = False  # -e; extra-region mode
    min_snv_num: int = 40     # -s; msn, minimum SNV number at L2
    # cutoff ladder [cov_cutoff, wa_cov_cutoff, ab_cutoff]
    # (StrainScan.py:194-217): primary then retry (retry sets l2=1)
    cutoff_primary: Tuple[float, float, float] = (0.1, 0.4, 1.0)
    cutoff_retry: Tuple[float, float, float] = (0.05, 0.05, 1.0)
    cutoff_ldep1: Tuple[float, float, float] = (0.01, 0.05, 1.0)
    cutoff_ldep2: Tuple[float, float, float] = (0.005, 0.01, 1.0)
    # node-size classes (identify.py:52-61); memory-efficient DB halves them
    # (identify_low_mem.py:50-64)
    node_weak: int = 1000
    node_small: int = 3000
    node_weak_mem: int = 500
    node_small_mem: int = 1500
    # search-time statistics
    outlier_factor: float = 100.0      # del_outlier: drop counts >= 100*median
    # (identify.py:106-112)
    binom_p: float = 0.995             # binomial descent test (identify.py:356)
    binom_alpha: float = 0.05          # (identify.py:357)
    qualified_cov: float = 0.95        # qualified parent gate (identify.py:349)
    ancestor_min_kmers: int = 1000     # get_ancestor_ab gate (identify.py:157)
    adjust_min_kmers: int = 1000       # adjust_profile remain gate (identify.py:181)
    alt_cov_cutoff: float = 0.1        # alternative fallback (identify.py:465)
    # L2 statistics
    l2_outlier_factor: float = 1000.0  # 1000*median ceiling (Vote_...:409)
    exist_relab: float = 0.02          # exist-evidence rel-ab (Vote_...:431)
    exist_cov: float = 0.7             # exist-evidence coverage (Vote_...:431)
    prescan_max_iter: int = 15         # Pre-Scan iterations (identify_strains:318)
    prescan_remainc: float = 0.2       # remain-coverage gate (identify_strains:354)
    prescan_default_cov: float = 0.7   # strain cov gate (identify_strains:250)
    emode_check_c: int = 5000          # extra-region candidate gate (:352)
    # Elastic-Net CV (identify_strains_L2_Enet_Pscan_new_sp.py:433-437)
    enet_cv_niter: int = 20
    enet_nalpha: int = 50
    enet_max_iter: int = 5000
    enet_test_size: float = 0.5
    enet_eps: float = 0.001
    enet_tol: float = 1e-4
    enet_l1_ratio: float = 0.5
    enet_seed: int = 0
    # low-depth probability transform (identify_low_depth.py:105-151)
    lowdep_scale: float = 180.0
    lowdep_cov_one: float = 0.05
    lowdep_min_valid: int = 1000
    # device batching
    read_batch: int = 65536            # reads per device batch
    max_read_len: int = 256            # padded read length bucket ceiling
    # minimum table size before multi-device index sharding pays for its
    # collectives; smaller tables (e.g. per-cluster L2 sets) run the fused
    # single-device pipeline even on a pod
    shard_min_kmers: int = 2_000_000
    # minimum L2 matrix row count before the Pre-Scan column sums and
    # Enet fold Grams shard their k-mer axis over the mesh (the O(s)
    # outputs cross ICI via one psum; below this the dispatch+collective
    # latency exceeds the matvec itself)
    shard_min_l2_rows: int = 250_000

    def ladder(self) -> Tuple[Tuple[float, float, float], ...]:
        """Cutoff schedule for the chosen low-depth mode (StrainScan.py:192-217)."""
        if self.low_dep == 0:
            return (self.cutoff_primary, self.cutoff_retry)
        if self.low_dep == 1:
            return (self.cutoff_ldep1,)
        return (self.cutoff_ldep2,)


DEFAULT_BUILD = BuildConfig()
DEFAULT_IDENTIFY = IdentifyConfig()
