"""Host milliseconds a block in the engine layer's calls,
``FullKernelBatchEngine.push_planes`` and ``step_packets`` (the harness's
``engine.*`` spans over the measured window)."""


def read(ctx):
    s = ctx.spans.layer_seconds("engine")
    if not s or not ctx.iterations:
        return None
    return 1e3 * s / ctx.iterations
