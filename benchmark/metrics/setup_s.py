"""Set-up seconds: process start to the first timed unit (weights,
traffic, kernel builds and every shape the cell uses, warmed)."""


def read(rec):
    return rec.get("setup_s")
