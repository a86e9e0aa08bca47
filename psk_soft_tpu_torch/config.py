"""Demodulator configuration ("properties").

Host-only copy of ``psk_soft_tpu/config.py`` (same fields, validation and
properties; ``tests/test_torch_ops.py`` pins the field lists equal).  The JAX
package cannot be imported here: its ``__init__`` loads jax.

The six runtime properties of the reference component are declared in
``psk_soft.prf.xml:23-60``.  The config is a frozen dataclass; a property
change produces a new config (FullKernelBatchEngine.configure applies it).
"""

from __future__ import annotations

import dataclasses


_BITS_PER_SYMBOL = {2: 1, 4: 2, 8: 3, 16: 4, 32: 5}


@dataclasses.dataclass(frozen=True)
class DemodConfig:
    """Static configuration of one PSK demod chain.

    Attributes:
      sps: samples per symbol ("samplesPerBaud", psk_soft.prf.xml:23-28,
        default 10, recommended 8-10).
      num_avg: symbols averaged for timing recovery ("numAvg",
        psk_soft.prf.xml:29-34, default 100).
      constellation_size: M in {2, 4, 8, 16, 32} ("constelationSize",
        psk_soft.prf.xml:35-41, default 4).  The reference supports only
        {2, 4, 8} and warns on anything else (cpp/psk_soft.cpp:565-566);
        16/32-PSK are an extension using the same generalized mapping the
        reference's 8-PSK slicer implements (phase k*2pi/M -> binary k,
        LSB-first).
      phase_avg: points in the sliding linear fit of unwrapped phase
        ("phaseAvg", psk_soft.prf.xml:42-48, default 50).
      differential: differential decoding mode ("differentialDecoding",
        psk_soft.prf.xml:49-54, default False).
      matched_filter: optional front-end matched filter, an extension beyond
        the reference (which picks the max-energy raw sample directly,
        cpp/psk_soft.cpp:462-465): "none" (reference parity), "boxcar", or
        "rrc".
      rrc_beta: roll-off for the RRC matched filter.
      rrc_span: RRC filter half-span in symbols.
    """

    sps: int = 10
    num_avg: int = 100
    constellation_size: int = 4
    phase_avg: int = 50
    differential: bool = False
    matched_filter: str = "none"
    rrc_beta: float = 0.35
    rrc_span: int = 8
    # Feed-forward early-late timing refinement (extension; BASELINE.json
    # config 3): parabolic interpolation of the energy bins around the argmax
    # gives a fractional offset, and the decision sample is linearly
    # interpolated.  Off by default (reference parity: single-sample pick,
    # cpp/psk_soft.cpp:462-465).
    timing_interp: bool = False

    def __post_init__(self):
        if self.constellation_size not in _BITS_PER_SYMBOL:
            raise ValueError(
                f"constellation_size must be one of {sorted(_BITS_PER_SYMBOL)}; "
                f"got {self.constellation_size}"
            )
        if self.sps < 1:
            raise ValueError(f"sps must be >= 1; got {self.sps}")
        if self.num_avg < 1:
            raise ValueError(f"num_avg must be >= 1; got {self.num_avg}")
        if self.phase_avg < 1:
            raise ValueError(f"phase_avg must be >= 1; got {self.phase_avg}")
        if self.matched_filter not in ("none", "boxcar", "rrc"):
            raise ValueError(f"unknown matched_filter {self.matched_filter!r}")

    @property
    def bits_per_symbol(self) -> int:
        """Bits per baud: 2->1, 4->2, 8->3 (cpp/psk_soft.cpp:384-390)."""
        return _BITS_PER_SYMBOL[self.constellation_size]

    @property
    def window_samples(self) -> int:
        """Timing window length numAvg*sps ("numDataPts", cpp/psk_soft.cpp:377)."""
        return self.sps * self.num_avg

    def to_json(self) -> str:
        """Serialize (the PRF-file equivalent, psk_soft.prf.xml)."""
        import json
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "DemodConfig":
        import json
        return cls(**json.loads(s))

    @property
    def mf_ntaps(self) -> int:
        """Matched-filter length (0 when disabled)."""
        if self.matched_filter == "none":
            return 0
        if self.matched_filter == "boxcar":
            return self.sps
        return self.rrc_span * self.sps + 1
