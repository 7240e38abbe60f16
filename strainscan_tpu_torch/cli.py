"""StrainScan command line on PyTorch.

Subcommand flags mirror ``strainscan_tpu.cli`` (and through it the
reference CLIs), plus ``--device {cuda,cpu}`` for ``identify`` and
``batch-identify``: ``cuda`` counts on every visible GPU (one GPU: the
single-device path; several: the sharded path for large tables).
``build``, ``convert`` and ``subsample`` run on the host only, in the
port's own host modules (``build/``, ``io/``, ``native/``).

Multi-host: under ``torchrun`` (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK`` set) every process joins a gloo group, counts its
share of the read batches, and the counts are summed before the CST search
(``parallel/distributed.py``).

Usage:
    python -m strainscan_tpu_torch.cli build -i genomes/ -o DB
    python -m strainscan_tpu_torch.cli identify -i sample.fq -d DB -o out
    python -m strainscan_tpu_torch.cli batch-identify -i a.fq b.fq -d DB -o out
    python -m strainscan_tpu_torch.cli subsample -i genomes/ -o out -d 0.99
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import sys


def _add_build(sub):
    p = sub.add_parser("build", help="build a strain database")
    p.add_argument("-i", "--input_fasta", dest="input_fa", required=True,
                   help="dir of input fasta genomes")
    p.add_argument("-o", "--output_dir", dest="out_dir",
                   default=os.path.join(os.getcwd(), "StrainScan_DB"))
    p.add_argument("-c", "--cls_file", dest="cls_custom_file", default="",
                   help="custom clustering file (hclsMap format)")
    p.add_argument("-k", "--kmer_size", dest="ksize", type=int, default=31)
    p.add_argument("-t", "--threads", dest="threads", type=int, default=1)
    p.add_argument("-u", "--uk_num", dest="uknum", type=int, default=100000,
                   help="max unique k-mers per genome")
    p.add_argument("-g", "--gk_ratio", dest="gkratio", type=float,
                   default=1.0, help="ratio of group-specific k-mers")
    p.add_argument("-m", "--strainest_sample", dest="mas", type=int,
                   default=0, help="(compat flag; MSA-SNV k-mer mode)")
    p.add_argument("-e", "--memory_efficient", dest="mem", type=int,
                   default=0)
    p.add_argument("-n", "--mink_cutoff", dest="mink", type=int,
                   default=1000)
    p.add_argument("-x", "--maxk_cutoff", dest="maxk", type=int,
                   default=30000)
    p.add_argument("-r", "--maxn_cutoff", dest="maxn", type=int,
                   default=3000)
    p.add_argument("--exact-dist", action="store_true",
                   help="exact Jaccard distances instead of minhash")
    p.add_argument("--sketch-size", type=int, default=8192)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="skip build stages whose artifacts already exist")


def _add_device(p):
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device of the count and L2 kernels (default cuda: "
                        "every visible GPU; cuda without a usable GPU is an "
                        "error)")


def _add_identify(sub):
    p = sub.add_parser("identify", help="identify strains in a sample")
    p.add_argument("-i", "--input_fastq", dest="input_fq", required=True)
    p.add_argument("-j", "--input_fastq_2", dest="input_fq2", default="")
    p.add_argument("-d", "--database_dir", dest="db_dir", required=True)
    p.add_argument("-o", "--output_dir", dest="out_dir",
                   default=os.path.join(os.getcwd(), "StrainScan_Result"))
    p.add_argument("-k", "--kmer_size", dest="ksize", type=int, default=31)
    p.add_argument("-l", "--low_dep", dest="ldep", type=int, default=0,
                   choices=[0, 1, 2])
    p.add_argument("-b", "--strain_prob", dest="sprob", type=int, default=0)
    p.add_argument("-p", "--plasmid_mode", dest="pmode", type=int,
                   default=0, choices=[0, 1, 2])
    p.add_argument("-r", "--ref_genome", dest="rgenome", default="")
    p.add_argument("-e", "--extraRegion_mode", dest="emode", type=int,
                   default=0)
    p.add_argument("-s", "--minimum_snv_num", dest="msn", type=int,
                   default=40)
    _add_device(p)


def _add_batch_identify(sub):
    p = sub.add_parser(
        "batch-identify",
        help="identify many samples in one process (the DB and the device "
             "tables stay resident between samples)")
    p.add_argument("-i", "--input_fastq", dest="input_fqs", nargs="+",
                   required=True,
                   help="sample FASTQs; for paired-end pass R1,R2 "
                        "(comma-joined) per sample")
    p.add_argument("-d", "--database_dir", dest="db_dir", required=True)
    p.add_argument("-o", "--output_dir", dest="out_dir",
                   default=os.path.join(os.getcwd(), "StrainScan_Batch"))
    p.add_argument("-k", "--kmer_size", dest="ksize", type=int, default=31)
    p.add_argument("-l", "--low_dep", dest="ldep", type=int, default=0,
                   choices=[0, 1, 2])
    p.add_argument("-b", "--strain_prob", dest="sprob", type=int, default=0)
    p.add_argument("-e", "--extraRegion_mode", dest="emode", type=int,
                   default=0)
    p.add_argument("-s", "--minimum_snv_num", dest="msn", type=int,
                   default=40)
    _add_device(p)


def _add_convert(sub):
    p = sub.add_parser(
        "convert", help="convert between reference and native DB layouts")
    p.add_argument("-i", "--input_db", dest="in_db", required=True)
    p.add_argument("-o", "--output_db", dest="out_db", required=True)
    p.add_argument("--to-reference", action="store_true",
                   help="export a native DB in the reference layout "
                        "(default: import a reference DB)")
    p.add_argument("-k", "--kmer_size", dest="ksize", type=int, default=31)


def _add_subsample(sub):
    p = sub.add_parser("subsample", help="cluster genomes and pick reps")
    p.add_argument("-i", "--input_fasta", dest="input_fa", required=True)
    p.add_argument("-o", "--output_dir", dest="out_dir",
                   default=os.path.join(os.getcwd(), "StrainScan_Subsample"))
    p.add_argument("-c", "--cls_type", dest="cls_type", default="complete",
                   choices=["single", "complete"])
    p.add_argument("-d", "--distance", dest="dist", type=float, default=0.99)


def _identify_cfg(args, **kw):
    from strainscan_tpu_torch.config import IdentifyConfig

    return IdentifyConfig(
        ksize=args.ksize, low_dep=args.ldep, strain_prob=bool(args.sprob),
        extra_region=bool(args.emode), min_snv_num=args.msn, **kw)


def main(argv=None) -> int:
    logging.basicConfig(format="%(asctime)s - %(message)s",
                        level=logging.INFO)
    parser = argparse.ArgumentParser(
        prog="strainscan-torch",
        description="StrainScan on PyTorch — k-mer strain identification")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_build(sub)
    _add_identify(sub)
    _add_batch_identify(sub)
    _add_convert(sub)
    _add_subsample(sub)
    args = parser.parse_args(argv)

    # multi-host bootstrap (env-gated, a no-op without MASTER_ADDR)
    from strainscan_tpu_torch.parallel import distributed as dist

    if dist.maybe_initialize():
        idx, n = dist.process_info()
        logging.info("multi-host run: process %d/%d", idx, n)

    if args.cmd == "convert":
        from strainscan_tpu_torch.build import convert

        if args.to_reference:
            convert.export_reference_db(args.in_db, args.out_db)
        else:
            convert.import_reference_db(args.in_db, args.out_db,
                                        k=args.ksize)
        return 0

    if args.cmd == "build":
        from strainscan_tpu_torch.build.pipeline import build_database
        from strainscan_tpu_torch.config import BuildConfig

        cfg = BuildConfig(
            ksize=args.ksize, threads=args.threads, uk_num=args.uknum,
            gk_ratio=args.gkratio, memory_efficient=bool(args.mem),
            min_kmer=args.mink, max_kmer=args.maxk, max_cls_recon=args.maxn,
            sketch_size=args.sketch_size, exact_distance=args.exact_dist,
            seed=args.seed)
        if args.mas:
            print("note: -m/--strainest_sample MSA mode is subsumed by "
                  "presence-pattern k-mer selection")
        build_database(args.input_fa, args.out_dir, cfg,
                       custom_cls_file=args.cls_custom_file or None,
                       resume=args.resume)
        return 0

    if args.cmd == "identify":
        from strainscan_tpu_torch.identify.pipeline import run_identify

        if args.pmode in (1, 2) and not args.rgenome:
            print("Warning: You have to provide the dir of reference genome "
                  "sequences if you want to use plasmid mode!")
            return 1
        cfg = _identify_cfg(args, plasmid_mode=args.pmode)
        res = run_identify(args.input_fq, args.input_fq2, args.db_dir,
                           args.out_dir, args.device, cfg,
                           rgenome=args.rgenome)
        if res is None:
            print("Warning: No clusters can be detected!")
            return 1
        return 0

    if args.cmd == "batch-identify":
        from strainscan_tpu_torch.io.fastx import genome_prefix
        from strainscan_tpu_torch.identify.pipeline import run_identify
        from strainscan_tpu_torch.parallel.sharded import resolve_mesh

        # one process for the whole batch: the DB caches and the
        # device-resident tables stay warm between samples
        device = resolve_mesh(args.device)
        cfg = _identify_cfg(args)
        n_found = 0
        seen: dict = {}
        for spec in args.input_fqs:
            parts = spec.split(",")
            fq, fq2 = parts[0], parts[1] if len(parts) > 1 else ""
            name = genome_prefix(fq)
            if name in seen:   # duplicate prefixes get unique out dirs
                seen[name] += 1
                name = f"{name}.{seen[name]}"
            else:
                seen[name] = 0
            out = os.path.join(args.out_dir, name)
            logging.info("sample %s -> %s", spec, out)
            res = run_identify(fq, fq2, args.db_dir, out, device, cfg)
            if res is None:
                print(f"Warning: No clusters can be detected! ({name})")
            else:
                n_found += 1
        print(f"{n_found}/{len(args.input_fqs)} samples produced reports "
              f"under {args.out_dir}")
        return 0 if n_found else 1

    if args.cmd == "subsample":
        from strainscan_tpu_torch.build import cluster as cluster_mod
        from strainscan_tpu_torch.build import distance, select_rep
        from strainscan_tpu_torch.io import fastx

        cls_res = os.path.join(args.out_dir, "Cls_res")
        ref_dir = os.path.join(args.out_dir, "Rep_ref")
        os.makedirs(cls_res, exist_ok=True)
        os.makedirs(ref_dir, exist_ok=True)
        genomes = fastx.list_genomes(args.input_fa)
        genome_of = {fastx.genome_prefix(p): p for p in genomes}
        names, dist = distance.distance_matrix(genomes)
        distance.save_matrix(os.path.join(cls_res, "distance.npz"), names,
                             dist)
        cls = cluster_mod.hcls(names, dist, args.cls_type, 1 - args.dist)
        cut_pct = int(args.dist * 100)
        cluster_mod.write_cls_map(
            os.path.join(cls_res, f"hclsMap_{cut_pct}.txt"), cls)
        reps, _, _ = select_rep.pick_rep(names, dist, cls)
        for rep in reps.values():
            shutil.copy(genome_of[rep], ref_dir)
        print(f"{len(reps)} representatives copied to {ref_dir}")
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
