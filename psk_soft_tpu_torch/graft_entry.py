"""Entry points: the flagship step and a multi-shard dry run (port
of ``__graft_entry__.py:1-309``).

* :func:`entry` returns ``(fn, example_args)``: the channel-batched
  feed-forward block demodulator and a small input for it.
* :func:`dryrun_multichip` runs every sharded path once on tiny shapes
  over an ``n_devices``-shard mesh (channel x time sharding with halo
  exchange, all_gather seam combine and ppermute left shifts; kernel B1 on
  the time-sharded flagship, B3 + B4 in the streaming FEC, B2 in the
  decoder and the chain tails), with the same checks.

    python -m psk_soft_tpu_torch.graft_entry [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def entry(device="cuda"):
    """(fn, example_args): forward step on the flagship pipeline -- the
    channel-batched feed-forward block demodulator, on ``device``."""
    from psk_soft_tpu_torch.config import DemodConfig
    from psk_soft_tpu_torch.models.blockpsk import demod_block_ff, ff_init
    from psk_soft_tpu_torch.utils.transfer import to_device

    cfg = DemodConfig(sps=8, num_avg=100, constellation_size=4, phase_avg=50)
    channels, symbols = 8, 256
    state = ff_init(cfg, channels, device)
    rng = np.random.default_rng(0)
    x = to_device(
        (rng.standard_normal((channels, symbols * cfg.sps))
         + 1j * rng.standard_normal((channels, symbols * cfg.sps))
         ).astype(np.complex64), device)

    def fn(state, x):
        return demod_block_ff(cfg, state, x)

    return fn, (state, x)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run the sharded demod step over an ``n_devices``-shard mesh of
    ``device`` (``parallel/mesh.shard_devices``) on tiny shapes, then the
    time-sharded flagship, the sharded channelizer and the chan-sharded
    bit layer, each checked as the JAX dry run checks it."""
    from psk_soft_tpu_torch.config import DemodConfig
    from psk_soft_tpu_torch.parallel.mesh import (P, make_mesh,
                                                  shard_devices, shard_map)
    from psk_soft_tpu_torch.parallel.sharded import make_sharded_demod
    from psk_soft_tpu_torch.utils.transfer import to_device

    dev = torch.device(device)
    devices = shard_devices(dev, n_devices)
    cfg = DemodConfig(sps=8, num_avg=16, constellation_size=4, phase_avg=8)
    # Exercise BOTH mesh axes when possible: chan=2 x time=n/2 for even
    # device counts, otherwise all devices on the time axis.
    if n_devices >= 4 and n_devices % 2 == 0:
        chan_ax, time_ax = 2, n_devices // 2
    else:
        chan_ax, time_ax = 1, n_devices
    mesh = make_mesh(chan=chan_ax, time=time_ax, devices=devices)

    symbols_per_shard = 32
    total_symbols = symbols_per_shard * time_ax
    channels = 2 * chan_ax
    rng = np.random.default_rng(0)
    x = to_device(
        (rng.standard_normal((channels, total_symbols * cfg.sps))
         + 1j * rng.standard_normal((channels, total_symbols * cfg.sps))
         ).astype(np.complex64), dev)
    out = make_sharded_demod(cfg, mesh, total_symbols)(x)
    assert out.soft.shape == (channels, total_symbols)

    # The single-kernel time+channel-sharded flagship (kernel B1 per shard).
    if time_ax >= 2:
        from psk_soft_tpu_torch.parallel.sharded_full import (
            make_time_sharded_full_demod)

        cfg2 = DemodConfig(sps=8, num_avg=16, constellation_size=4,
                           phase_avg=12)
        chans2 = 128 * chan_ax
        syms2 = max(64, 16 + 12 + 9 + 8 + 16) * time_ax
        rng2 = np.random.default_rng(1)
        j = rng2.integers(0, 4, (chans2, syms2))
        xs = np.zeros((chans2, syms2 * 8), np.complex64)
        xs[:, 2::8] = np.exp(2j * np.pi * j / 4)
        x_re = to_device(np.ascontiguousarray(xs.real.T), dev)
        x_im = to_device(np.ascontiguousarray(xs.imag.T), dev)
        outs = make_time_sharded_full_demod(cfg2, mesh, syms2)(x_re, x_im)
        assert outs[0].shape == (syms2, chans2)

        # And the matched-filter + fractional-timing profile of the same
        # path (BASELINE config-3 family): the FIR tail rides the left
        # halo.
        cfg3 = DemodConfig(sps=8, num_avg=16, constellation_size=8,
                           phase_avg=12, matched_filter="rrc", rrc_span=4,
                           timing_interp=True)
        outs3 = make_time_sharded_full_demod(cfg3, mesh, syms2)(x_re, x_im)
        assert outs3[0].shape == (syms2, chans2)

        # Wideband front: the row-sharded polyphase DFT channelizer
        # (K-1-row halo ppermute) shares the demod's "time" axis, so
        # capture -> channels -> bits composes on one mesh without
        # re-sharding (parallel/wideband.py).
        from psk_soft_tpu_torch.ops.channelizer import prototype_taps
        from psk_soft_tpu_torch.parallel.wideband import \
            make_sharded_channelize

        Cw, Kw = 16, 6
        rows = 8 * time_ax
        runw = make_sharded_channelize(prototype_taps(Cw, Kw), Cw, mesh)
        rngw = np.random.default_rng(2)
        zw = to_device((rngw.standard_normal((rows, Cw))
                        + 1j * rngw.standard_normal((rows, Cw))
                        ).astype(np.complex64), dev)
        assert runw(zw).shape == (rows, Cw)

    # Bit layer: the channel-sharded streaming FEC (constellation LLRs ->
    # depuncture -> B3 -> windowed traceback B4) rides the same `chan`
    # axis with zero collectives.
    from psk_soft_tpu_torch.ops.fec import (CODE_K7, ViterbiStreamState,
                                            make_stream_soft_fn,
                                            viterbi_stream_init)

    fec_chans = 2 * chan_ax
    rngf = np.random.default_rng(3)
    soft_f = to_device(
        np.exp(2j * np.pi * rngf.integers(0, 4, (fec_chans, 64)) / 4)
        .astype(np.complex64), dev)
    fec_fn = make_stream_soft_fn(CODE_K7, 4)
    st_f = viterbi_stream_init(CODE_K7, fec_chans, 70, device=dev)

    def per_shard(pm_s, dec_s, soft_s):
        st2, bits = fec_fn(ViterbiStreamState(pm=pm_s, dec=dec_s), soft_s)
        return st2.pm, st2.dec, bits

    fec_specs = (P("chan", None), P(None, "chan", None), P("chan", None))
    _, _, bits_f = shard_map(per_shard, mesh, in_specs=fec_specs,
                             out_specs=fec_specs, collectives=False)(
        st_f.pm, st_f.dec, soft_f)
    assert bits_f.shape == (fec_chans, 64)

    # And the decoder itself (B2 on the card) on a sharded batch axis.
    from psk_soft_tpu_torch.ops.fec import conv_encode, hard_llrs, \
        viterbi_decode

    bits_in = rngf.integers(0, 2, (fec_chans, 10)).astype(np.int8)
    llr_f = hard_llrs(conv_encode(CODE_K7, bits_in)).to(dev)
    out_bits = shard_map(lambda rows: viterbi_decode(CODE_K7, rows), mesh,
                         in_specs=P("chan", None),
                         out_specs=P("chan", None),
                         collectives=False)(llr_f)
    assert np.array_equal(out_bits.cpu().numpy(), bits_in)

    # The fixed-capacity device frame sync (sync_extract_topk) on the chan
    # axis: the building block of the one-program receive chain.
    from psk_soft_tpu_torch.ops.framesync import (FrameFormat,
                                                  sync_extract_topk)

    rngs = np.random.default_rng(4)
    fmt = FrameFormat(uw=tuple(rngs.integers(0, 4, 16)), payload=8, m=4,
                      threshold=0.7)
    sync_chans = 2 * chan_ax
    s_len = 96
    idx_s = rngs.integers(0, 4, (sync_chans, s_len))
    idx_s[:, 20:20 + fmt.uw_len] = np.asarray(fmt.uw)
    soft_s = to_device(np.exp(1j * (2 * np.pi * idx_s / 4 + np.pi / 4))
                       .astype(np.complex64), dev)
    sync = shard_map(lambda rows: tuple(sync_extract_topk(rows, fmt, 2)),
                     mesh, in_specs=P("chan", None),
                     out_specs=(P("chan", None, None), P("chan", None),
                                P("chan", None), P("chan", None),
                                P("chan")),
                     collectives=False)(soft_s)
    assert sync[1][:, 0].all() and int(sync[2][:, 0].min()) >= 0

    # The COMPOSED public chain tail (models/chain.chain_tail: sync -> LLRs
    # -> B2 -> CRC) sharded, decoding a planted coded frame exactly on
    # every shard.
    from psk_soft_tpu_torch.models.chain import (ChainOutputs,
                                                 chain_msg_bits, chain_tail,
                                                 make_seam_tail_fn,
                                                 seam_tail_init)
    from psk_soft_tpu_torch.ops import tx
    from psk_soft_tpu_torch.ops.crc import CRC16_CCITT

    fmt_c = FrameFormat(uw=tuple(rngs.integers(0, 4, 16)), payload=40,
                        m=4, threshold=0.7)
    n_msg_c = chain_msg_bits(fmt_c, CODE_K7, CRC16_CCITT)
    info_c = rngs.integers(0, 2, n_msg_c).astype(np.int8)
    row_c = tx.frame_stream(fmt_c, [info_c], [20], 128, code=CODE_K7,
                            crc=CRC16_CCITT, labeling="gray", seed=9)
    soft_c = np.exp(1j * (2 * np.pi * np.tile(row_c, (sync_chans, 1)) / 4
                          + np.pi / 4)).astype(np.complex64)
    cre = to_device(np.ascontiguousarray(soft_c.real.T), dev)
    cim = to_device(np.ascontiguousarray(soft_c.imag.T), dev)
    cspec = P(None, "chan")
    ospec = ChainOutputs(msg=P("chan", None, None), ok=P("chan", None),
                         found=P("chan", None), pos=P("chan", None),
                         ang=P("chan", None), count=P("chan"))
    out_c = shard_map(lambda r, i: chain_tail(r, i, fmt_c, CODE_K7, 1,
                                              crc=CRC16_CCITT,
                                              labeling="gray"),
                      mesh, in_specs=(cspec, cspec), out_specs=ospec,
                      collectives=False)(cre, cim)
    want = np.tile(info_c, (sync_chans, 1))
    assert out_c.found.all() and out_c.ok.all()
    assert bool((out_c.pos == 20).all())
    assert np.array_equal(out_c.msg[:, 0].cpu().numpy(), want)

    # The seam chain: the same composition with the CARRIED soft tail
    # (models/chain.make_seam_tail_fn) -- a frame straddling two blocks
    # decodes exactly once, on every shard.
    s_blk = 64
    start_str = s_blk - fmt_c.uw_len - 8      # frame spans the seam
    assert start_str + fmt_c.frame_len > s_blk
    row_str = tx.frame_stream(fmt_c, [info_c], [start_str], 2 * s_blk,
                              code=CODE_K7, crc=CRC16_CCITT,
                              labeling="gray", seed=11)
    soft_str = np.exp(1j * (2 * np.pi
                            * np.tile(row_str, (sync_chans, 1)) / 4
                            + np.pi / 4)).astype(np.complex64)
    str_re = to_device(np.ascontiguousarray(soft_str.real.T), dev)
    str_im = to_device(np.ascontiguousarray(soft_str.imag.T), dev)
    seam_step = make_seam_tail_fn(fmt_c, CODE_K7, 1, crc=CRC16_CCITT,
                                  labeling="gray")

    def seam_body(re_t, im_t):
        t0 = seam_tail_init(fmt_c, re_t.shape[1], re_t.device)
        t1, o1 = seam_step(t0, re_t[:s_blk], im_t[:s_blk])
        _, o2 = seam_step(t1, re_t[s_blk:], im_t[s_blk:])
        return o1, o2

    o1, o2 = shard_map(seam_body, mesh, in_specs=(cspec, cspec),
                       out_specs=(ospec, ospec),
                       collectives=False)(str_re, str_im)
    assert not o1.found.any()                 # not final in block 1
    assert o2.found.all() and o2.ok.all()
    assert bool((o2.pos[:, 0] == start_str - s_blk).all())
    assert np.array_equal(o2.msg[:, 0].cpu().numpy(), want)


def main(argv=None) -> int:
    from psk_soft_tpu_torch.examples import parse_device

    device = parse_device(__doc__, argv)
    if device is None:
        return 2
    fn, args = entry(device)
    _, out = fn(*args)
    print("entry ok:", {k: tuple(v.shape) for k, v in out._asdict().items()})
    dryrun_multichip(8, device)
    print("dryrun_multichip(8) ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
