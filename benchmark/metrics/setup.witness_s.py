"""Seconds of set-up spent on create_witness (synthesis and the witness
file), every instance's together (the benchmark's own span)."""


def read(ctx):
    return ctx["setup"].get("witness_s")
