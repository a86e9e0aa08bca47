"""Host milliseconds a block in the program's ``psk.engine.fetch`` span:
the device-to-host fetches of each block's planes (``engine_bank.to_host``
inside ``BankAssembler.assemble_tm``), any wait for the device included,
over the program's traced stretch (``portbench/program.py``)."""

from portbench import program


def read(ctx):
    return program.span_ms(ctx, "psk.engine.fetch")
