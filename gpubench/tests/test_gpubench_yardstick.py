"""The roofline counts against the figures the receiver's chip_smoke.py
published at the main path's shapes (K1 at 1024 blocks; K2 at N = 12 over
8,388,608 frames)."""

import numpy as np

from gpubench import yardstick
from gpubench.reference import stencil as rs
from gpubench.reference.protocols import build_decoder_config, new_parser


def geometry(window_blocks=1024):
    cfg = build_decoder_config([new_parser(n, 72) for n in ("scm", "scm+", "idm", "r900")])
    return rs.window_geometry(cfg, window_blocks)


def test_k1_bytes_at_the_main_path():
    geo = geometry()
    assert yardstick.staged_samples(geo) == 8_525_824
    n_words = -(-geo.window // 32)
    live = [np.zeros((len(g), n_words), bool) for g in geo.groups]
    work = yardstick.stencil_work(geo, live, 16.73e12)
    assert work["bytes"] == 42_429_008
    assert work["bound_by"] == "bytes"
    assert abs(work["bound_ms"] - 42_429_008 / 3.35e12 * 1e3) < 1e-12


def test_card_rate():
    assert yardstick.card_rate(64, {"sms": 132, "clock_max_mhz": 1980.0}) == 64 * 132 * 1.98e9


def test_k2_counts_at_the_published_shape():
    rate = yardstick.card_rate(yardstick.FP32_INSTR_PER_CLOCK_PER_SM,
                               {"sms": 132, "clock_max_mhz": 1980.0})
    work = yardstick.channelizer_work(12, 8, 8_388_608, rate)
    assert work["f32_instr"] == 9_999_220_736 == 1_192 * 8_388_608
    assert work["bytes"] == 402_653_376
    assert work["bound_by"] == "operations"
    assert abs(work["bound_ms"] - 0.29889) < 1e-5
    assert "bound_ms" not in yardstick.channelizer_work(12, 8, 8_388_608)


def test_mix_count_equals_the_receivers_cheapest_mix():
    from rtlamr_tpu_torch.ops.channelizer_mix import mix_op_count

    for n in range(1, 33):
        assert yardstick.mix_op_count(n) == mix_op_count(n), n
