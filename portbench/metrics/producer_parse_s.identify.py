"""``producer_parse_s.identify``: seconds per sample of the program's
``count/parse`` spans (each parse of a read batch,
``fastx.read_batches``, in the count's producer thread), summed per
sample, over both counts of an identify (the main count and the L2 union
count), averaged over the window's samples (``portbench/spans.py`` lays
the program's span ring over the trace)."""

from portbench import spans


def read(obs):
    return spans.per_sample(obs, "count/parse")
