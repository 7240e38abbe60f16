"""``count_wait_s.identify``: seconds per sample of the program's
``count/wait`` spans (each wait of the count's main thread for the
producer's next batch), summed per sample, over both counts of an
identify (the main count and the L2 union count), averaged over the
window's samples (``portbench/spans.py`` lays the program's span ring
over the trace)."""

from portbench import spans


def read(obs):
    return spans.per_sample(obs, "count/wait")
