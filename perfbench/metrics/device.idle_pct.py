"""The share of the traced window in which no operation ran on the device."""

from perfbench.reduce import idle_pct


def read(rec):
    t = rec.get("trace")
    if not t:
        return None
    return idle_pct(t["busy_s"], t["window_s"])
