"""Host milliseconds a block in the program's ``psk.engine.upload`` span:
the plane staging and the host-to-device copy of each steady block
(``FullKernelBatchEngine._take_plane_rows``), over the program's traced
stretch (``portbench/program.py``)."""

from portbench import program


def read(ctx):
    return program.span_ms(ctx, "psk.engine.upload")
