"""Per-layer metric readers, one file each, found by the metric's name
(``manifest.Manifest.metric_reader``).  A reader is ``read(ctx)`` and
returns a number, or None where it finds nothing to read; the harness then
leaves the metric out of the line.  ``ctx`` carries:

* ``cell``: the ``manifest.Cell``; ``pool``: the capture;
* ``iterations``: blocks fed in the window; ``spans``: the window's
  ``spans.Spans`` (host seconds by span name);
* ``trace``: the traced stretch's ``devtrace.Trace`` or None;
* ``ports``: the names of the outputs the path's user takes;
* ``roofline(kernel)``: the module ``rooflines/<kernel>.py``.
"""
