"""``producer_parse_s.count``: seconds per sample of the program's
``count/parse`` spans (each parse of a read batch,
``fastx.read_batches``, in the count's producer thread), summed per
sample, averaged over the window's samples (``portbench/spans.py`` lays
the program's span ring over the trace)."""

from portbench import spans


def read(obs):
    return spans.per_sample(obs, "count/parse")
