"""The queue of unconsumed stream bytes (rtlamr_tpu_torch/decoder/byte_queue.py)
that the narrowband and wideband streaming decoders feed through: however
the bytes arrive, it hands out the windows and keeps the remainder that one
concatenate of them gives; flush's whole blocks come zero-padded to a
window; a discard empties it."""

import numpy as np
import pytest

from rtlamr_tpu_torch.decoder.byte_queue import ByteQueue

WINDOW = 48
BLOCK = 12
DATA = (np.arange(1000) * 37 % 251).astype(np.uint8)

CHUNKINGS = {
    "one_byte": [1] * 300,
    "odd_sizes": [7, 13, 1, 29, 0, 3, 61, 11] * 12,
    "window_multiples": [WINDOW, 2 * WINDOW, 3 * WINDOW, WINDOW],
    "many_small_reads": [5] * 180,
    "one_read": [997],
    "past_a_window_each": [WINDOW + 1] * 20,
}


def pushed(sizes):
    """A queue fed ``DATA`` in chunks of ``sizes``, the windows it handed
    out after each push, and the bytes fed."""
    q, windows, pos = ByteQueue(), [], 0
    for size in sizes:
        chunk = DATA[pos : pos + size].copy()
        pos += chunk.size
        q.push(chunk)
        chunk[:] = 0  # the queue holds its own copy
        windows += [w.copy() for w in q.take(WINDOW)]
        assert q.size == pos - len(windows) * WINDOW < WINDOW
    return q, windows, pos


@pytest.mark.parametrize("sizes", list(CHUNKINGS.values()), ids=list(CHUNKINGS))
def test_windows_and_remainder_as_one_concatenate(sizes):
    q, windows, fed = pushed(sizes)
    whole = DATA[:fed]
    k = fed // WINDOW
    assert len(windows) == k
    for i, w in enumerate(windows):
        assert np.array_equal(w, whole[i * WINDOW : (i + 1) * WINDOW])
    assert np.array_equal(q.state(), whole[k * WINDOW :])


@pytest.mark.parametrize("rest", [0, BLOCK - 1, BLOCK, 2 * BLOCK + 5, WINDOW - 1])
def test_flush_blocks_zero_padded_to_a_window(rest):
    q = ByteQueue()
    q.push(DATA[: rest // 2])
    q.push(DATA[rest // 2 : rest])
    padded, count = q.take_blocks(BLOCK, WINDOW)
    k = rest // BLOCK
    assert count == k
    if k == 0:
        assert padded is None and q.size == rest
    else:
        assert padded.dtype == np.uint8 and padded.size == WINDOW
        assert np.array_equal(padded[: k * BLOCK], DATA[: k * BLOCK])
        assert not padded[k * BLOCK :].any()
        assert np.array_equal(q.state(), DATA[k * BLOCK : rest])


@pytest.mark.parametrize("sizes", [[], [5], [WINDOW - 1, 1, 30]], ids=["empty", "one", "past"])
def test_discard_and_state_round_trip(sizes):
    q, _, fed = pushed(sizes)
    left = q.state()
    again = ByteQueue(left)
    assert again.size == q.size == left.size and np.array_equal(again.state(), left)
    assert q.discard() == fed % WINDOW
    assert q.size == 0 and q.state().size == 0 and q.take(1) == []
    assert q.take_blocks(1, WINDOW) == (None, 0)
    q.push(DATA[:WINDOW])
    assert np.array_equal(q.take(WINDOW)[0], DATA[:WINDOW])
