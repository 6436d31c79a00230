"""Host synchronisations per call of the fleet, over every source directory
that made them (the sync debug mode): the batched front end's and the S
back ends', and the reset of every stream's state that a counting pass of
session traffic starts with."""


def read(rec):
    if "syncs" not in rec:
        return None
    return sum(rec["syncs"].values()) / rec["sync_calls"]
