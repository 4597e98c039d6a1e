"""Median host milliseconds of a call into the program's entry, from the
call to its return with no synchronise: what the host pays to submit."""


def read(r):
    return r.median_ms("entry")
