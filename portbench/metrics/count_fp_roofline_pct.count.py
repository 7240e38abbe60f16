"""``count_fp_roofline_pct.count``: Σ least time ÷ Σ kernel time of the
window's ``count_fp`` kernels, in percent.

The least time of a batch is the larger of its bytes over the HBM peak and
its operations over the 32-bit peak (``portbench.peaks``), the bytes and
operations being what the batch's inputs need (``portbench.roofline``),
counted by the reference's probe of each distinct sample; the kernel time
is the device trace's, summed over every device."""

from portbench import roofline, trace

KERNELS = ("fp_coarse_count_kernel", "fp_coarse_scatter_kernel",
           "fp_fine_split_kernel", "fp_bin_probe_kernel")


def read(obs):
    if obs.get("events") is None:
        return None
    work = obs["run"].state.get("work")
    kernel_s = trace.kernel_seconds(obs["events"], KERNELS, obs["span"])
    if not work or kernel_s <= 0:
        return None
    least = sum(roofline.least_time(work[r["sample"]])
                for r in obs["records"])
    return 100.0 * least / kernel_s
