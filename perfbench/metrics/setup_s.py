"""Seconds from the start of the run to the start of the window: imports,
the CCL build or load, rendering the inputs, building and warming the program."""


def read(rec):
    return rec["setup_s"]
