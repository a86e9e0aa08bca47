"""Bytes that crossed the host-device bus a sample: the program's
``psk.engine.h2d_bytes`` and ``psk.engine.d2h_bytes`` counters (the plane
uploads and the fetches of ``engine_bank.to_host``) over the input samples
of the blocks fed in the program's traced stretch
(``portbench/program.py``).  A program whose engine runs on the host moves
none: 0."""

from portbench import program

COUNTERS = ("psk.engine.h2d_bytes", "psk.engine.d2h_bytes")


def read(ctx):
    prog = program.read(ctx)
    if not prog or "psk.engine.upload" not in prog["spans"] \
            or not prog["samples"]:
        return None
    return sum(prog["counters"].get(k, 0) for k in COUNTERS) \
        / prog["samples"]
