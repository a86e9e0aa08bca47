"""Evaluation tools (host-side numpy): carrier-offset estimation so far."""
