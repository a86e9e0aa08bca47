"""Kernel B1's share of its roofline, in percent: the least time its work
needs at the cell's shapes and mode (``rooflines/b1.py``: float32 or int16
planes, float32 or int8 soft, the debug planes where the cell's user takes
them) over B1's device time a launch in the traced stretch.  B1's launches
are its stages' kernels, found by name: ``demod_timing`` (stage A),
``demod_track`` (stage B, one a launch), ``demod_fir`` (stage 0)."""

from portbench.rooflines import bound_s

STAGES = ("demod_timing", "demod_track", "demod_fir")
ONE_A_LAUNCH = "demod_track"


def read(ctx):
    if ctx.trace is None:
        return None
    busy = launches = 0
    for name, (sec, count) in ctx.trace.ops.items():
        if any(s in name for s in STAGES):
            busy += sec
        if ONE_A_LAUNCH in name:
            launches += count
    if not launches or busy <= 0:
        return None
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    d = cfg["demod"]
    ops, nbytes = ctx.roofline("b1").work(
        cfg["channels"], cfg["block_symbols"], d["sps"], d["num_avg"],
        d["phase_avg"], in_bytes=2 if tr["wire"] == "i16" else 4,
        soft_bytes=1 if tr["soft"] == "i8" else 4,
        debug_ports={"phase", "sampleIndex"} <= set(ctx.ports))
    return 100.0 * bound_s(ops, nbytes) * launches / busy
