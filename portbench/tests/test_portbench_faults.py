"""A run whose timed path is broken underneath comes out not correct: a
step that returns its state unchanged, half of the batch left out, an
answer altered where it is produced (the cells run on one chip, so there
is no exchange between chips to leave out)."""

import pytest

from psk_soft_tpu_torch.runtime.streams import PORT_BITS

from .helpers import break_path, run_tiny


def state_unchanged(path):
    eng = path.engine
    step = eng._steady_step

    def stuck(x_re, x_im):
        before = eng._full_state
        out = step(x_re, x_im)
        eng._full_state = before
        return out

    eng._steady_step = stuck


def half_left_out(path):
    eng = path.engine
    step = eng.step_packets

    def half():
        pkts = step()
        for p in (pkts or {}).values():
            p.data = p.data[:p.data.shape[0] // 2]
        return pkts

    eng.step_packets = half


def answer_altered(path):
    eng = path.engine
    step = eng.step_packets

    def flip():
        pkts = step()
        if pkts and PORT_BITS in pkts:
            d = pkts[PORT_BITS].data
            d[0, 0] ^= 1
        return pkts

    eng.step_packets = flip


@pytest.mark.parametrize("workload", ["qpsk1024.ports", "qpsk1024.i16"])
@pytest.mark.parametrize("fault", [state_unchanged, half_left_out,
                                   answer_altered],
                         ids=["state_unchanged", "half_left_out",
                              "answer_altered"])
def test_fault_is_not_correct(monkeypatch, workload, fault):
    break_path(monkeypatch, fault)
    line, _ = run_tiny(workload)
    assert line["correct"] is False
