"""The port's twelve-channel wideband decoder (``parallel/wideband.py`` on
its plain PyTorch path: K2's twelve-branch mix, twelve window programs a
super-step) against the benchmark's frozen NumPy reference
(``gpubench/reference/``): its float32 channelizer over the whole stream,
then its exact-integer decoder on every channel. The stream is the
whole-band deployment's (``gpubench/configs/wb12_all.json``, its traffic
mix ``live_64``: a train of packets on each channel, overlapping in time),
cut to chip length 8 and a few super-steps."""

import json
import pathlib

import numpy as np
import pytest
import torch

from gpubench import check
from gpubench.reference import channelizer as rc
from gpubench.reference.decoder import ReferenceDecoder
from gpubench.reference.protocols import new_parser as ref_parser
from gpubench.traffic.plan import make_plan, render, window_blocks
from rtlamr_tpu_torch.parallel import WidebandDecoder
from rtlamr_tpu_torch.protocols import new_parser

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHIP = 8
#: a seed of the benchmark's size, and one past 32 signed bits
SEEDS = [3_240_000_017, 2**32 + 11]
#: super-steps decoded
STEPS = 3


@pytest.fixture(scope="module", params=SEEDS)
def stream(request):
    """(config, plan, wideband bytes of STEPS whole super-steps)."""
    cfg = json.loads((ROOT / "gpubench" / "configs" / "wb12_all.json").read_text())
    mix = json.loads((ROOT / "gpubench" / "traffic" / "live_64.json").read_text())
    cfg.update(symbollength=CHIP, sample_rate=65536,
               flags=[f.replace("-symbollength=72", f"-symbollength={CHIP}") for f in cfg["flags"]])
    mix.update(lead_seconds=0.1, tail_seconds=0.1)
    plan = make_plan(cfg, mix, request.param, 3.0)
    wb = render(cfg, plan)
    step = 2 * plan.channels * plan.window
    assert plan.window == window_blocks(mix) * plan.block_size and wb.size >= STEPS * step
    return cfg, plan, wb[: STEPS * step]


def test_twelve_channels_equal_the_reference(stream):
    cfg, plan, wb = stream
    n = plan.channels
    assert n == 12
    dec = WidebandDecoder([new_parser(t, CHIP) for t in cfg["msgtype"]], n_channels=n,
                          window_blocks=window_blocks({"flags": ["-windowblocks=64"]}),
                          device="cpu")
    assert dec.spec.window == plan.window
    msgs = dec.decode_capture(wb)
    got = [(b, c, check.canonical(m.msg_type(), m.to_dict(), c)) for c, b, m in msgs]
    rows = rc.channelize(n, wb.view(np.uint16), None)
    want = []
    for c in range(n):
        ref = ReferenceDecoder([ref_parser(t, CHIP) for t in cfg["msgtype"]], arithmetic="int")
        want += [(b, c, check.canonical(m.msg_type(), m.to_dict(), c))
                 for b, m in ref.decode_capture(rows[c].view(np.uint8))]
    key = lambda t: t[:2]  # noqa: E731 - block, then channel; each decoder's order within
    assert sorted(got, key=key) == sorted(want, key=key)
    assert len({c for _, c, _ in got}) == n
    # Every channel carries packets, and every packet sent whole decodes on
    # its own channel.
    sent = STEPS * plan.window
    ids = {(c, m.meter_id()) for c, _, m in msgs}
    whole = [p for p in plan.packets if p.end + plan.packet_length < sent]
    assert {p.channel for p in whole} == set(range(n))
    assert {(p.channel, p.meter_id) for p in whole} <= ids
