"""The served paths a cell can drive, one module per entry point named in a
traffic mix's ``entry``: ``engine`` (bank -> FullKernelBatchEngine ->
packets).

Each module defines ``Path(config, traffic, pool, device, sample)``:

* ``feed(b, span)`` pushes stream block ``b`` through the chain, every call
  into the program inside ``span(name)``, the harness's timer, and returns
  the stream block whose outputs reached the user in this call (None if
  none did) with the work they carry: ``{"samples": ...}``, and
  ``"failed": 1`` where they were malformed;
* ``window``, set by the harness, is true while the measured window runs;
  the path then copies the deliveries that ``sample`` (a ``Reservoir``)
  picks into buffers it allocated and filled during set-up, so the window
  keeps nothing of the program's on the heap;
* ``ports``: the names of the outputs the path's user takes;
* ``close()`` frees the program's state;
* ``check(dtype, device)`` compares what was kept against the reference and
  returns (numbers compared, information).
"""

import numpy as np


class Reservoir:
    """A uniform sample of ``slots`` of the window's deliveries, drawn from
    the seed (reservoir sampling): ``slot(n)`` is the slot the n-th
    delivery goes to, or None."""

    def __init__(self, seed: int, slots: int):
        self.slots = int(slots)
        self.rng = np.random.default_rng([int(seed), 1])

    def slot(self, n: int):
        if n < self.slots:
            return n
        j = int(self.rng.integers(0, n + 1))
        return j if j < self.slots else None


def ingest(bank, pool, b: int, samples: int, span):
    """The bank's side of a block: stream block ``b``'s wire pushed as a
    channelizer hands it over, then ``samples`` rows of time-major planes
    popped."""
    with span("ingest.push_interleaved"):
        bank.push_interleaved(pool.block(b).reshape(-1))
    with span("ingest.pop_planes"):
        re, im, _ = bank.pop_planes(samples, timeout=0)
    return re, im
