from strainscan_tpu_torch.io.fastx import (  # noqa: F401
    read_fasta,
    read_batches,
    genome_kmers,
    list_genomes,
    genome_prefix,
)
