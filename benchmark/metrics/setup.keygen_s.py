"""Seconds of keygen() in set-up (the benchmark's own span around it)."""


def read(ctx):
    return ctx["setup"].get("keygen_s")
