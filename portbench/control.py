"""The control of the correctness check: the plain reference put in the
program's place, computed in bfloat16, the precision below the float32 the
configurations state.  It must come out not correct.

    python3 -m portbench.control --workload <name> --seeds <n> [<n> ...]

builds each seed's capture as a run does (at the cell's own size, on the
GPU where there is one), computes the reference in bfloat16 and in float64,
hands the bfloat16 outputs of ``--blocks`` consecutive stream blocks to the
cell's comparison as if the program had delivered them, and prints one JSON
line a seed: the numbers compared, each beside its limit, and ``correct``.
The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import check
from .manifest import Manifest
from .pool import make_pool
from .reference import psk

FIRST_BLOCK = 40           # past any warm-up, in the pool's second pass


def ports_outputs(ref_low: dict, pool, demod: psk.Demod, blocks,
                  soft_scale: float | None) -> dict:
    """The engine path's kept blocks, as the low-precision reference would
    have delivered them."""
    s, na = pool.block_symbols, demod.num_avg
    nb = int(np.log2(demod.constellation_size))
    kept = {}
    for b in blocks:
        e = check.ref_index(pool, np.arange((b - 1) * s, (b + 1) * s), na)
        soft = ref_low["soft"][:, e[s:]].numpy().astype(np.complex64)
        if soft_scale is not None:
            q = lambda v: np.clip(np.round(v * soft_scale), -127, 127)  # noqa
            soft = ((q(soft.real) + 1j * q(soft.imag)) / soft_scale).astype(
                np.complex64)
        code = ref_low["code"][:, e[s:]].numpy()
        bits = ((code[..., None] >> np.arange(nb)) & 1).reshape(
            code.shape[0], -1).astype(np.int16)
        sidx = ref_low["sidx"][:, e].numpy().astype(np.int16)
        kept[b] = (soft, bits, ref_low["phase"][:, e[s:]].numpy().astype(
            np.float32), sidx[:, s:], sidx[:, :s])
    return kept


def control(cell, seed: int, blocks: int, dtype=torch.bfloat16,
            device="cpu") -> dict:
    traffic = cell.traffic
    pool = make_pool(cell.config, traffic, seed, device)
    demod = psk.Demod.from_config(cell.config["demod"])
    span = range(FIRST_BLOCK, FIRST_BLOCK + blocks)
    ref = check.run_reference(pool, demod, None, torch.float64, device)
    low = check.run_reference(pool, demod, None, dtype, device)
    scale = (float(traffic["soft_i8_scale"]) if traffic["soft"] == "i8"
             else None)
    numbers, info = check.compare_ports(
        ports_outputs(low, pool, demod, span, scale), ref, pool, demod,
        scale)
    correct, lines = check.judge(numbers, cell.limits)
    return {"workload": cell.name, "seed": int(seed),
            "precision": str(dtype).replace("torch.", ""),
            "correct": correct, "info": info, "check": lines}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--blocks", type=int, default=24)
    args = ap.parse_args(argv)
    cell = Manifest().cell(args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        print(json.dumps(control(cell, seed, args.blocks, device=device)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
