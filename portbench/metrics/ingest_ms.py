"""Host milliseconds a block in the ingest layer's calls,
``NativePlaneBank.push_interleaved`` and ``pop_planes`` (the harness's
``ingest.*`` spans over the measured window)."""


def read(ctx):
    s = ctx.spans.layer_seconds("ingest")
    if not s or not ctx.iterations:
        return None
    return 1e3 * s / ctx.iterations
