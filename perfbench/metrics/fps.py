"""Frames completed over the whole window, per second (host clock)."""


def read(rec):
    return rec["frames"] / rec["window_s"]
