"""Runnable examples of the port, one module each:

    python -m psk_soft_tpu_torch.examples.<name> [--device cpu]

``bank_demod``, ``coded_link``, ``frame_sync``, ``hetero_rate_bank``,
``one_launch_chain``, ``sharded_mesh``, ``stream_demod`` and
``wideband_bank`` are the JAX package's ``examples/`` at the same sizes,
printing the same results.  They run on the GPU unless ``--device cpu`` is
given (the plain versions of the kernels); without a GPU they stop and say
so.
"""

from __future__ import annotations

import argparse
import sys


def parse_args(doc: str, argv=None, add_arguments=None):
    """The example's arguments: ``--device`` (default ``cuda``) and those
    ``add_arguments(parser)`` adds; None after telling the user that no GPU
    is there."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu (the plain "
                         "versions of the kernels)")
    if add_arguments is not None:
        add_arguments(ap)
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            print("no CUDA device; pass --device cpu", file=sys.stderr)
            return None
    return args


def parse_device(doc: str, argv=None):
    """The example's ``--device`` (default ``cuda``), or None after telling
    the user that no GPU is there."""
    args = parse_args(doc, argv)
    return None if args is None else args.device
