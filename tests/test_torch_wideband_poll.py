"""The wideband decoder's completion policy (``parallel/wideband.py``): a
super-step in flight completes at the first ``feed`` whose ``poll`` finds
its results landed on the host (``decoder/pipeline.py`` ``ready``, which
never waits), at the latest at the next dispatch. The triples are those of
``decode_capture`` whatever the chunking; a super-step whose copy has not
landed stays in flight; ``_Events.query`` answers for the wideband mesh's
handles; the live CLI prints the lines of a ``-fromfile`` run of the same
bytes and counts the super-steps a poll completed.

The ``cuda`` test runs on a machine without JAX:
``python -m pytest --noconftest tests/test_torch_wideband_poll.py -m cuda``."""

from __future__ import annotations

import contextlib
import io
import re
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from rtlamr_tpu_torch.cli.main import main
from rtlamr_tpu_torch.decoder import pipeline
from rtlamr_tpu_torch.parallel import WidebandDecoder, WidebandMeshDecoder, wideband
from rtlamr_tpu_torch.parallel.mesh import _Events
from rtlamr_tpu_torch.protocols import new_parser
from rtlamr_tpu_torch.protocols.base import build_decoder_config
from rtlamr_tpu_torch.ref import synth
from rtlamr_tpu_torch.utils import observability
from rtlamr_tpu_torch.utils.observability import CAPACITY, TRACER

torch.set_num_threads(1)

N = 4
CHIP = 8
NAMES = ("scm", "scm+", "idm", "r900")
BLOCK = build_decoder_config([new_parser(p, CHIP) for p in NAMES]).block_size
#: the CLI's super-step: 128 blocks, two of the throughput preset's 256 KiB
#: reads, so a super-step is dispatched every second read and polled at
#: the read after
CLI_BLOCKS = 128
#: the library tests' super-step: 24 blocks, under a 256 KiB read
LIB_BLOCKS = 24
STEPS = 3
SAMPLES = STEPS * CLI_BLOCKS * BLOCK
TIMESTAMP = re.compile(r"\d{4}-\d\d-\d\dT[\d:.]+Z?")
CLI_ARGS = ["-msgtype=all", f"-symbollength={CHIP}", f"-channels={N}", "-format=json",
            f"-windowblocks={CLI_BLOCKS}"]


@pytest.fixture(scope="module")
def wb():
    """Four channels, three 128-block super-steps (sixteen of 24 blocks):
    a packet of each type on each channel in turn, some across a
    super-step's end."""
    planted = []
    for k in range(12):
        c = k % N
        at = k * (SAMPLES // 12) + 1500 + 200 * c
        if k % 4 == 0:
            burst = synth.bits_to_burst(synth.make_scm_bits(meter_id=8100 + k, consumption=k), at)
        elif k % 4 == 1:
            burst = synth.bits_to_burst(synth.make_scmplus_bits(endpoint_id=8100 + k), at)
        elif k % 4 == 2:
            burst = synth.r900_burst(synth.make_r900_symbols(meter_id=8100 + k), at)
        else:
            burst = synth.bits_to_burst(synth.make_idm_bits(serial=8100 + k), at)
        planted.append((c, burst))
    for s in range(1, STEPS):  # across each 128-block super-step's end
        planted.append((s % N, synth.bits_to_burst(
            synth.make_scm_bits(meter_id=8200 + s, consumption=s), s * CLI_BLOCKS * BLOCK - 600)))
    out = synth.render_wideband(SAMPLES, planted, N, CHIP, amplitude=90.0, noise=2.0, seed=25)
    assert out.size == STEPS * 2 * (1 << 18)
    return out


def port(window_blocks=LIB_BLOCKS, device="cpu"):
    return WidebandDecoder([new_parser(p, CHIP) for p in NAMES], n_channels=N,
                           window_blocks=window_blocks, device=device)


def as_list(msgs):
    return [(c, b, str(m)) for c, b, m in msgs]


def chunk_sizes(kind, total, dec):
    if kind == "read256k":
        return [1 << 18] * -(-total // (1 << 18))
    if kind == "block":
        return [2 * N * BLOCK] * (total // (2 * N * BLOCK))
    if kind == "superstep":
        return [dec.window_bytes] * (total // dec.window_bytes)
    rng = np.random.default_rng(25)
    sizes = []
    while sum(sizes) < total:
        sizes.append(min(int(rng.integers(1, 3 * dec.window_bytes)), total - sum(sizes)))
    return sizes


def polls_expected(sizes, step_bytes):
    """Super-steps the CPU's polls complete: on the CPU a copy has always
    landed, so a feed that finds a super-step in flight completes it."""
    polled, queued, in_flight = 0, 0, False
    for n in sizes:
        if in_flight:
            polled, in_flight = polled + 1, False
        queued += n
        k, queued = divmod(queued, step_bytes)
        if k:
            in_flight = True
    return polled


@pytest.mark.parametrize("kind", ["read256k", "block", "superstep", "ragged"])
def test_chunkings_give_decode_capture_triples(wb, kind):
    """(a) Fed in 256 KiB reads, a block at a time, a super-step at a time
    or ragged, the decoder gives decode_capture's triples in its order;
    every feed that finds a super-step in flight completes it."""
    want = as_list(port().decode_capture(wb))
    assert len({m for _, _, m in want}) >= 12
    dec = port()
    sizes = chunk_sizes(kind, wb.size, dec)
    got, pos = [], 0
    for n in sizes:
        got.extend(as_list(dec.feed(wb[pos : pos + n])))
        pos += n
    got.extend(as_list(dec.flush()))
    assert pos == wb.size and got == want
    assert dec.metrics.windows_polled == polls_expected(sizes, dec.window_bytes)
    if kind in ("block", "superstep"):  # every super-step but the last
        assert dec.metrics.windows_polled == dec.metrics.windows_decoded - 1 == 15


class Gate:
    """A stand-in copy event: lands when the test says so; ``synchronize``
    (a wait) is counted."""

    def __init__(self):
        self.landed = False
        self.waits = 0

    def query(self):
        return self.landed

    def synchronize(self):
        self.waits += 1
        self.landed = True


def test_a_super_step_completes_once_its_copy_has_landed(wb, monkeypatch):
    """(b) Not landed: neither poll() nor feed completes it, and it stays
    in flight. Landed: the next feed completes it once, ahead of what that
    feed dispatches; ready() never waits."""
    want = as_list(port().decode_capture(wb))
    gates, log = [], []
    real_fetch, real_step = wideband.enqueue_fetch, wideband._wideband_step

    def enqueue_fetch(buf):
        gates.append(Gate())
        return real_fetch(buf)[0], gates[-1]

    def step(*args):
        log.append(("dispatch", dec._window_index))
        return real_step(*args)

    def complete(inflight):
        log.append(("complete", inflight[1][3]))
        return real_complete(inflight)

    monkeypatch.setattr(wideband, "enqueue_fetch", enqueue_fetch)
    monkeypatch.setattr(wideband, "_wideband_step", step)
    dec = port()
    real_complete = dec._complete
    monkeypatch.setattr(dec, "_complete", complete)
    w, block = dec.window_bytes, 2 * N * BLOCK

    got = as_list(dec.feed(wb[:w]))  # super-step 0 dispatched
    assert got == [] and dec.in_flight and len(gates) == 1
    assert dec.poll() == [] and dec.feed(wb[w : w + block]) == []
    assert dec.in_flight and dec.metrics.windows_decoded == 0 and gates[0].waits == 0
    gates[0].landed = True
    got += as_list(dec.feed(wb[w + block : 2 * w]))  # completes 0, dispatches 1
    assert log == [("dispatch", 0), ("complete", 0), ("dispatch", 1)]
    assert dec.metrics.windows_decoded == dec.metrics.windows_polled == 1
    assert got == [t for t in want if t[1] < LIB_BLOCKS]
    assert dec.poll() == [] and dec.metrics.windows_decoded == 1  # once
    # not landed at the next dispatch: that dispatch completes it (a wait)
    got += as_list(dec.feed(wb[2 * w : 3 * w]))
    assert gates[1].waits == 1 and dec.metrics.windows_polled == 1
    assert got == [t for t in want if t[1] < 2 * LIB_BLOCKS] and got
    assert log[-2:] == [("dispatch", 2), ("complete", 1)]
    got += as_list(dec.feed(wb[3 * w :])) + as_list(dec.flush())
    assert got == want

    for landed in (False, True):
        gate = Gate()
        gate.landed = landed
        assert pipeline.ready((None, gate)) is landed and gate.waits == 0
    assert pipeline.ready((None, None))


class Event:
    def __init__(self, done):
        self.done = done

    def query(self):
        return self.done

    def synchronize(self):
        raise AssertionError("query() must not wait")


@pytest.mark.parametrize("states", [(), (True,), (False,), (True, True), (True, False),
                                    (False, True)])
def test_mesh_events_query(states):
    """(c) A mesh handle's events have landed only when every device's has."""
    events = _Events(Event(s) for s in states)
    assert events.query() is all(states)
    assert pipeline.ready((None, events)) is all(states)


def test_wideband_mesh_polls_and_keeps_its_triples(wb):
    """(c) The wideband mesh decoder inherits the poll: fed in 256 KiB
    reads on the CPU it completes super-batches at the next read and gives
    the WidebandDecoder's triples."""
    want = as_list(port().decode_capture(wb))
    dec = WidebandMeshDecoder([new_parser(p, CHIP) for p in NAMES], n_channels=N,
                              mesh_shape=(2, 2), devices=["cpu"] * 4,
                              window_blocks=LIB_BLOCKS)
    got = []
    for pos in range(0, wb.size, 1 << 18):
        got.extend(as_list(dec.feed(wb[pos : pos + (1 << 18)])))
    got.extend(as_list(dec.flush()))
    assert got == want
    assert 0 < dec.metrics.windows_polled < dec.metrics.windows_decoded


class ClosingServer(threading.Thread):
    """A local rtl_tcp server: the dongle header, then the stream in
    ``piece``-byte sends ``pace`` seconds apart, then the end of the
    stream; it reads the tuner commands until the client closes."""

    def __init__(self, iq, piece=1 << 20, pace=0.0):
        super().__init__(daemon=True)
        self.iq = np.asarray(iq, np.uint8).tobytes()
        self.piece, self.pace = piece, pace
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(1)
        self.port = self.sock.getsockname()[1]

    def run(self):
        conn, _ = self.sock.accept()
        try:
            conn.sendall(b"RTL0" + struct.pack(">II", 5, 29))
            for pos in range(0, len(self.iq), self.piece):
                conn.sendall(self.iq[pos : pos + self.piece])
                time.sleep(self.pace)
            conn.shutdown(socket.SHUT_WR)
            conn.settimeout(15.0)
            while conn.recv(4096):
                pass
        except OSError:
            pass
        finally:
            conn.close()
            self.sock.close()


def run_cli(argv, device="cpu"):
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(argv, device=device)
    finally:
        observability.disable()
        TRACER.capacity = CAPACITY
        TRACER.reset()
    assert rc == 0, err.getvalue()
    return TIMESTAMP.sub("<time>", out.getvalue()).splitlines(), err.getvalue()


def live(iq, extra=(), device="cpu", **server):
    srv = ClosingServer(iq, **server)
    srv.start()
    try:
        return run_cli(CLI_ARGS + [f"-server=127.0.0.1:{srv.port}", "-duration=60s", *extra],
                       device)
    finally:
        srv.join(timeout=20)


def polled(err):
    """(super-steps, those a poll completed) from ``-metrics``' line."""
    m = re.search(r"^super-steps: (\d+) \((\d+) completed by a poll\), ", err, re.M)
    assert m, err
    return int(m.group(1)), int(m.group(2))


def test_live_cli_lines_equal_a_file_run(wb, tmp_path):
    """(d) Live in the throughput preset the CLI prints a -fromfile run's
    lines byte for byte, Offset and Length included, and dumps the same
    sample file; every super-step but the one the flush completes was
    completed by a poll, each with its ``wideband.poll`` span."""
    path = tmp_path / "wb.bin"
    wb.tofile(path)
    want, _ = run_cli(CLI_ARGS + [f"-fromfile={path}", f"-samplefile={tmp_path / 'file.iq'}"])
    got, err = live(wb, ["-metrics", f"-samplefile={tmp_path / 'live.iq'}"])
    assert got == want and len(want) >= 14
    assert any('"Offset":0' not in line for line in want)
    assert (tmp_path / "live.iq").read_bytes() == (tmp_path / "file.iq").read_bytes()
    assert polled(err) == (STEPS, STEPS - 1)
    m = re.search(r"^wideband\.poll\s+(\d+)\s", err, re.M)
    assert m and int(m.group(1)) == STEPS - 1


@pytest.mark.cuda
def test_cuda_live_super_steps_complete_by_a_poll(wb, tmp_path):
    """On the card, at a few ms a read, a poll completes every super-step
    but the last (the flush's) and the stream is the CPU decoder's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the channelizer and stencil kernels run only there")
    warm = port(CLI_BLOCKS, device=None)
    warm.decode_capture(wb[: warm.window_bytes])
    torch.cuda.synchronize()  # the kernels built and the search's graph captured
    path = tmp_path / "wb.bin"
    wb.tofile(path)
    want, _ = run_cli(CLI_ARGS + [f"-fromfile={path}"])
    got, err = live(wb, ["-metrics"], device=None, piece=1 << 15, pace=0.002)
    assert got == want and len(want) >= 14
    assert polled(err) == (STEPS, STEPS - 1)
