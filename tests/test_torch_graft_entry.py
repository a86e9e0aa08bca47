"""Port parity, the entry points: psk_soft_tpu_torch/graft_entry
against ``__graft_entry__.py`` on the CPU.

- ``entry()``: the flagship feed-forward step on its example input gives
  JAX's outputs (the same fields and shapes; valid masks, bits and sample
  index equal, soft and phase within 1e-4 where JAX's own feed-forward
  tests hold them, tests/test_torch_blockpsk.py).
- ``dryrun_multichip(n, device="cpu")`` runs every sharded section and its
  checks on 2, 3 and 8 CPU shards (8: chan 2 x time 4, as JAX's dry run on
  its 8 virtual devices; 3: all on time; 2: time only), and JAX's dry run
  passes on the same 8.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from psk_soft_tpu_torch import graft_entry

torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import __graft_entry__ as jax_entry  # noqa: E402


def test_entry_matches_jax():
    import jax

    fn, args = graft_entry.entry("cpu")
    _, out = fn(*args)
    jfn, jargs = jax_entry.entry()
    _, ref = jax.jit(jfn)(*jargs)
    got = {k: np.asarray(v) for k, v in out._asdict().items()}
    want = {k: np.asarray(v) for k, v in ref._asdict().items()}
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].shape == want[k].shape, k
    for k in ("valid", "bits", "sample_index"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("soft", "phase"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("n", [2, 3, 8])
def test_dryrun_multichip_on_cpu_shards(n):
    graft_entry.dryrun_multichip(n, device="cpu")


def test_jax_dryrun_on_the_same_eight():
    jax_entry.dryrun_multichip(8)


def test_main_needs_a_gpu_or_cpu_flag(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert graft_entry.main([]) == 2
    assert "--device cpu" in capsys.readouterr().err
