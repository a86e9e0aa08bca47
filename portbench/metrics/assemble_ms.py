"""Host milliseconds a block of the program's ``psk.engine.emit`` self
time: the packet assembly on the host (``BankAssembler.assemble_tm``'s
unpack, soft build and transposes, and ``record_packets``), its fetches
left out, over the program's traced stretch (``portbench/program.py``)."""

from portbench import program


def read(ctx):
    return program.span_ms(ctx, "psk.engine.emit", "self_seconds")
