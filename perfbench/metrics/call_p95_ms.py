"""95th percentile over every call of the window, from its start to its
answers on the host (host clock): a chunk in the SLAM cells, a batch of
frames in the fleet."""

from perfbench.reduce import percentile


def read(rec):
    return percentile(rec["calls_s"], 95) * 1e3
