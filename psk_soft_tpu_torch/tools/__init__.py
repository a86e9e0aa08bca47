"""Tools of the port run by hand: the bench, kernel timers and the
correctness gates they share with ``chip_smoke.py``."""
