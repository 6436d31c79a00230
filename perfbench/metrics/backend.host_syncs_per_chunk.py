"""Host synchronisations made by the SLAM back end (slam/) per chunk,
from the sync debug mode."""


def read(rec):
    if "syncs" not in rec:
        return None
    return rec["syncs"].get("slam", 0) / rec["sync_calls"]
