"""setup_s: seconds from the run's start to the end of warm-up
(generation, the store's write, plans, kernel builds and warm-up)."""


def read(rec, trace):
    return rec["setup_s"]
