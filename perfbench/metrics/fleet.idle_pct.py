"""The share of the fleet's traced window in which no operation ran on the
device: the batched front end and the S back ends of a call together."""

from perfbench.reduce import idle_pct


def read(rec):
    t = rec.get("trace")
    if not t:
        return None
    return idle_pct(t["busy_s"], t["window_s"])
