"""Mesh sharding: channel + time-block parallel demod (port of
``psk_soft_tpu/parallel``), on a (chan, time) grid of torch devices."""
