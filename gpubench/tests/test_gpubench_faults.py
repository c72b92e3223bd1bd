"""The whole run on the CPU at a tiny size, with the timed path broken
underneath, sees ``correct`` come out false: once for each fault a cell can
have (its state returned unchanged, half of its answers left out, an
answer altered where it is produced, an answer added that the stream does
not hold, a kernel's output altered; a cell on
one card has no exchange between cards to leave out), and true when
nothing is broken. A wideband cell adds its own: a frame of K2's output
altered, a message put on another channel, the ghosts on neighbouring
channels dropped, one planted packet's message withheld."""

import dataclasses

import pytest

from conftest import tiny, wide_tiny

PIPELINE = "rtlamr_tpu_torch.decoder.pipeline"


def _carry_unchanged(monkeypatch):
    """The window decoder's carried halo never advances."""
    from rtlamr_tpu_torch.decoder.pipeline import WindowDecoder

    orig = WindowDecoder.process_host_staged

    def stuck(self, staged, valid_blocks=None):
        carry = self._carry
        out = orig(self, staged, valid_blocks)
        self._carry = carry
        return out

    monkeypatch.setattr(WindowDecoder, "process_host_staged", stuck)


def _half_the_messages(monkeypatch):
    """Every second message the window decoder produces is dropped."""
    from rtlamr_tpu_torch.decoder.pipeline import WindowDecoder

    orig = WindowDecoder._parse_window
    count = [0]

    def half(self, res, valid_blocks, window_index):
        out = []
        for m in orig(self, res, valid_blocks, window_index):
            count[0] += 1
            if count[0] % 2:
                out.append(m)
        return out

    monkeypatch.setattr(WindowDecoder, "_parse_window", half)


def _answer_altered(monkeypatch):
    """The first message of each window has its first number field off by
    one."""
    from rtlamr_tpu_torch.decoder.pipeline import WindowDecoder

    orig = WindowDecoder._parse_window

    def altered(self, res, valid_blocks, window_index):
        out = orig(self, res, valid_blocks, window_index)
        if out:
            b, msg = out[0]
            f = next(f.name for f in dataclasses.fields(msg)
                     if isinstance(getattr(msg, f.name), int))
            out[0] = (b, dataclasses.replace(msg, **{f: getattr(msg, f) + 1}))
        return out

    monkeypatch.setattr(WindowDecoder, "_parse_window", altered)


def _one_line_planted(monkeypatch):
    """One message the stream does not hold: beside the first message the
    window decoder finds at block 160 or later (past any warm-up stream), a
    copy of it with its first number field off by one."""
    from rtlamr_tpu_torch.decoder.pipeline import WindowDecoder

    orig = WindowDecoder._parse_window
    planted = []

    def plant(self, res, valid_blocks, window_index):
        out = orig(self, res, valid_blocks, window_index)
        late = [(b, msg) for b, msg in out if b >= 160]
        if late and not planted:
            b, msg = late[0]
            f = next(f.name for f in dataclasses.fields(msg)
                     if isinstance(getattr(msg, f.name), int))
            planted.append(b)
            out = out + [(b, dataclasses.replace(msg, **{f: getattr(msg, f) + 1}))]
        return out

    monkeypatch.setattr(WindowDecoder, "_parse_window", plant)


def _k1_altered(monkeypatch):
    """K1's bit stream has one bit flipped in every window."""
    from rtlamr_tpu_torch.ops import frontend

    orig = frontend.decode_stencil

    def flipped(spec, staged, first):
        bits, q6, mask = orig(spec, staged, first)
        bits = bits.clone()
        bits[len(bits) // 2] ^= 1
        return bits, q6, mask

    monkeypatch.setattr(frontend, "decode_stencil", flipped)


def _k2_altered(monkeypatch):
    """K2 writes one channel sample off by one in every super-step."""
    from rtlamr_tpu_torch.parallel import wideband

    orig = wideband.channelize_requantize_fused

    def flipped(spec, hist, wb, first, out=None, **kw):
        res = orig(spec, hist, wb, first, out=out, **kw)
        res[1, res.shape[1] // 2] ^= 1
        return res

    monkeypatch.setattr(wideband, "channelize_requantize_fused", flipped)


def _wideband_messages(monkeypatch, edit):
    """Each super-step's (channel, block, message) triples go through
    ``edit(triples, decoder)`` where the wideband decoder produces them."""
    from rtlamr_tpu_torch.parallel.wideband import WidebandDecoder

    orig = WidebandDecoder._complete

    def complete(self, inflight):
        return edit(orig(self, inflight), self)

    monkeypatch.setattr(WidebandDecoder, "_complete", complete)


def _channel_relabelled(monkeypatch):
    """The first message of each super-step is put on the next channel."""
    def edit(out, dec):
        if out:
            c, b, m = out[0]
            out[0] = ((c + 1) % dec.n_channels, b, m)
        return out

    _wideband_messages(monkeypatch, edit)


def _ghosts_dropped(monkeypatch):
    """The wideband decoder drops same-message copies on other channels
    (``-crosschanneldedup``) while the CLI asked to keep them."""
    from rtlamr_tpu_torch.parallel.wideband import WidebandDecoder

    orig = WidebandDecoder.__init__

    def init(self, *a, **kw):
        orig(self, *a, **kw)
        self.cross_channel_dedup = True

    monkeypatch.setattr(WidebandDecoder, "__init__", init)


def _one_message_withheld(monkeypatch):
    """The thirtieth message of the timed call (the process's second wideband
    decoder) is never emitted."""
    decoders, count = [], [0]

    def edit(out, dec):
        if dec not in decoders:
            decoders.append(dec)
        if decoders.index(dec) != 1:
            return out
        keep = []
        for t in out:
            count[0] += 1
            if count[0] != 30:
                keep.append(t)
        return keep

    _wideband_messages(monkeypatch, edit)


CASES = [
    ("nb_all.live16", None),
    ("nb_all.live16", _carry_unchanged),
    ("nb_all.live16", _half_the_messages),
    ("nb_all.live16", _answer_altered),
    ("nb_all.live16", _k1_altered),
    ("nb_all.live16", _one_line_planted),
    ("wb4_test.parallel", _k1_altered),
    ("wb4_test.parallel", _half_the_messages),
    ("wb4_test.parallel", _k2_altered),
    ("wb4_test.parallel", _channel_relabelled),
    ("wb4_test.parallel", _ghosts_dropped),
    ("wb4_test.parallel", _one_message_withheld),
    ("wb4_test.parallel", _one_line_planted),
]


@pytest.mark.parametrize("name,fault", CASES,
                         ids=[f"{c[0]}-{c[1].__name__ if c[1] else 'sound'}" for c in CASES])
def test_fault_makes_correct_false(name, fault, monkeypatch, run_tiny):
    cell = wide_tiny(name.split(".")[1]) if name.startswith("wb4_test.") else tiny(name)
    if fault is not None:
        fault(monkeypatch)
    res = run_tiny(cell, seconds=2.0)
    numbers = {k: v["value"] for k, v in res["checks"].items()}
    if fault is None:
        assert res["correct"], numbers
        assert res["attempted"] > 0 and res["failed"] == 0
    else:
        assert not res["correct"], numbers
