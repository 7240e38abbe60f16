"""``count_wait_s.count``: seconds per sample of the program's
``count/wait`` spans (each wait of the count's main thread for the
producer's next batch), summed per sample, averaged over the window's
samples (``portbench/spans.py`` lays the program's span ring over the
trace)."""

from portbench import spans


def read(obs):
    return spans.per_sample(obs, "count/wait")
