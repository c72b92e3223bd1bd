"""The whole run on the CPU at a tiny size, with the timed path broken
underneath, sees ``correct`` come out false: once for each fault a cell can
have (its state returned unchanged, half of its answers left out, an
answer altered where it is produced, a kernel's output altered; a cell on
one card has no exchange between cards to leave out), and true when
nothing is broken."""

import dataclasses

import pytest

from conftest import tiny

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


CASES = [
    ("nb_all.live16", None),
    ("nb_all.live16", _carry_unchanged),
    ("nb_all.live16", _half_the_messages),
    ("nb_all.live16", _answer_altered),
    ("nb_all.live16", _k1_altered),
]


@pytest.mark.parametrize("name,fault", CASES,
                         ids=[f"{c[0]}-{c[1].__name__ if c[1] else 'sound'}" for c in CASES])
def test_fault_makes_correct_false(name, fault, monkeypatch, run_tiny):
    cell = tiny(name)
    if fault is not None:
        fault(monkeypatch)
    res = run_tiny(cell, seconds=2.0)
    numbers = {k: v["value"] for k, v in res["checks"].items()}
    if fault is None:
        assert res["correct"], numbers
        assert res["attempted"] > 0 and res["failed"] == 0
    else:
        assert not res["correct"], numbers
