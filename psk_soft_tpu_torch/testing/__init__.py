"""Test-signal generators and the reference-semantics oracle (numpy
copies of ``psk_soft_tpu/testing``, so the port's checks need no JAX)."""
