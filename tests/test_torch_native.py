"""The port's native (C++) transport, rtlamr_tpu_torch/native: the JAX
package's tests/test_native.py cases against the port's copy of the library
(a fake rtl_tcp server: greeting, 5-byte command wire format, byte-stream
integrity through the ring, read deadline, EOF; the mmap capture reader;
``read_staged`` from the file and the ring equal to the port's staging; the
live CLI; the ring under ThreadSanitizer), plus ``read_staged`` into
``torch.uint16`` tensors and its refusals, the native file path through
``process_host_staged`` against the JAX decoder's, and ``-ingest=auto``
opening the native source when the library builds.

The JAX package is imported inside the tests that use it, so the ``cuda``
test runs on a machine without JAX:
``python -m pytest --noconftest tests/test_torch_native.py -m cuda``."""

from __future__ import annotations

import contextlib
import io
import json
import pathlib
import shutil
import socket
import struct
import subprocess
import threading
import time

import numpy as np
import pytest
import torch

from rtlamr_tpu_torch import native
from rtlamr_tpu_torch.cli.main import Receiver
from rtlamr_tpu_torch.cli.main import main as cli_main
from rtlamr_tpu_torch.cli.main import run as cli_run
from rtlamr_tpu_torch.cli.flags import build_flagset
from rtlamr_tpu_torch.decoder import WindowDecoder
from rtlamr_tpu_torch.decoder.pipeline import StagingRing
from rtlamr_tpu_torch.io.capture import FileSource, RtlTcpSource, StdinSource
from rtlamr_tpu_torch.io.rtltcp import RtlTcpClient
from rtlamr_tpu_torch.ops.spec import staged_geometry
from rtlamr_tpu_torch.ops.stencil import decode_stencil
from rtlamr_tpu_torch.protocols import new_parser
from rtlamr_tpu_torch.protocols.base import build_decoder_config
from rtlamr_tpu_torch.ref import synth

# The suite runs in several worker processes at once; torch's default of one
# intra-op thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SAMPLE = str(ROOT / "tests" / "fixtures" / "sample.bin")
NAMES = ("scm", "scm+", "idm", "r900")


@pytest.fixture(autouse=True)
def _library():
    """Every test here needs the library: its build failing is a failure,
    not a skip (g++ is part of the port's toolchain)."""
    assert native.available(), native.load_error()


class FakeServer(threading.Thread):
    """Minimal rtl_tcp server: greeting, command capture, data replay
    (tests/test_native.py's)."""

    def __init__(self, payload: bytes, chunk: int = 8192, linger: float = 0.5):
        super().__init__(daemon=True)
        self.payload = payload
        self.chunk = chunk
        self.linger = linger
        self.commands = []
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(1)
        self.port = self.sock.getsockname()[1]

    def run(self):
        conn, _ = self.sock.accept()
        conn.sendall(b"RTL0" + struct.pack(">II", 5, 29))
        conn.settimeout(0.05)
        pos = 0
        buf = b""
        deadline = time.monotonic() + 10.0
        try:
            while time.monotonic() < deadline:
                try:
                    buf += conn.recv(64)
                    while len(buf) >= 5:
                        self.commands.append(struct.unpack(">BI", buf[:5]))
                        buf = buf[5:]
                except socket.timeout:
                    pass
                except OSError:
                    break
                if pos < len(self.payload):
                    end = min(pos + self.chunk, len(self.payload))
                    conn.sendall(self.payload[pos:end])
                    pos = end
                elif self.linger <= 0:
                    break
                else:
                    time.sleep(0.02)
                    self.linger -= 0.02
        except (BrokenPipeError, ConnectionResetError):
            pass
        finally:
            conn.close()
            self.sock.close()


def test_library_is_built_into_the_port_build_dir():
    path = pathlib.Path(native.library_path())
    assert path.parent == ROOT / "rtlamr_tpu_torch" / "_build" and path.exists()
    assert path.name.startswith("ingest-") and path.suffix == ".so"
    assert not (ROOT / "rtlamr_tpu_torch" / "native" / "_ingest.so").exists()


def test_connect_header_and_stream_integrity():
    rng = np.random.default_rng(7)
    payload = rng.integers(0, 256, size=300_000, dtype=np.uint8).tobytes()
    srv = FakeServer(payload)
    srv.start()

    client = native.NativeRtlTcpClient(f"127.0.0.1:{srv.port}")
    info = client.connect(timeout=5.0)
    assert info.tuner_type == 5 and info.tuner_name == "R820T"
    assert info.gain_count == 29

    got = b""
    while len(got) < len(payload):
        got += client.read_samples(
            min(70_000, len(payload) - len(got)), deadline=5.0
        ).tobytes()
    assert got == payload  # exact byte stream through the ring

    total, dropped, _buffered = client.stats()
    assert total >= len(payload)
    assert dropped == 0
    assert RtlTcpSource(client).dropped_bytes() == 0
    client.close()


def test_command_wire_format():
    srv = FakeServer(b"\x00" * 1024, linger=1.0)
    srv.start()
    client = native.NativeRtlTcpClient(f"127.0.0.1:{srv.port}")
    client.connect(timeout=5.0)
    client.set_center_freq(912_600_155)
    client.set_sample_rate(2_359_296)
    client.set_gain_mode(manual=False)  # reference auto-gain => arg 1
    client.set_tuner_gain(496)
    client.read_samples(1024, deadline=5.0)
    time.sleep(0.3)  # let the server's recv loop drain the commands
    client.close()
    srv.join(timeout=5.0)
    assert (0x01, 912_600_155) in srv.commands
    assert (0x02, 2_359_296) in srv.commands
    assert (0x03, 1) in srv.commands
    assert (0x04, 496) in srv.commands


def test_read_deadline():
    srv = FakeServer(b"\x00" * 16, linger=5.0)
    srv.start()
    client = native.NativeRtlTcpClient(f"127.0.0.1:{srv.port}")
    client.connect(timeout=5.0)
    client.read_samples(16, deadline=5.0)
    t0 = time.monotonic()
    with pytest.raises(OSError):
        client.read_samples(1024, deadline=0.3)
    assert 0.2 < time.monotonic() - t0 < 3.0
    client.close()


def test_eof_after_close():
    srv = FakeServer(b"\x01\x02\x03\x04", linger=0.0)
    srv.start()
    client = native.NativeRtlTcpClient(f"127.0.0.1:{srv.port}")
    client.connect(timeout=5.0)
    assert client.read_samples(4, deadline=5.0).tobytes() == b"\x01\x02\x03\x04"
    with pytest.raises((EOFError, OSError)):
        # Server closed; drain returns short then EOF.
        for _ in range(50):
            client.read_samples(1024, deadline=0.2)
    client.close()


def test_file_source_mmap(tmp_path):
    data = np.arange(100_000, dtype=np.uint32).view(np.uint8)
    p = tmp_path / "cap.bin"
    data.tofile(p)
    src = native.NativeFileSource(str(p))
    assert src.size == data.size
    a = src.read(12345)
    b = src.read(400_000 - 12345)
    tail = src.read(10)
    assert tail.size == 0
    assert np.array_equal(np.concatenate([a, b]), data)
    src.seek(4)
    again = src.read(8)
    assert np.array_equal(again, data[4:12])
    src.close()


def small_decoder(max_hits=256, names=("scm",)):
    return WindowDecoder([new_parser(n, 8) for n in names], window_blocks=4,
                         max_hits=max_hits, device="cpu")


def py_staged(spec, iq, i, carry):
    """Window ``i`` staged as ``WindowDecoder._process_window`` stages it
    behind ``carry``; (buffer, the next carry)."""
    geo = staged_geometry(spec)
    w, hs = spec.window, spec.halo_staged
    st = np.zeros(geo.staged_samples, np.uint16)
    st[:hs] = carry
    st[hs : hs + w] = iq[i * 2 * w : (i + 1) * 2 * w].view(np.uint16)
    return st, st[w : w + hs].copy()


def test_file_read_staged_matches_stage_host(tmp_path):
    """The native to-staged file pop produces exactly the buffers the
    port's staging builds (carry placement, pad alignment, carry update),
    and streaming decode over them is message-identical."""
    dec = small_decoder()
    spec = dec.spec
    geo = staged_geometry(spec)
    w, hs = spec.window, spec.halo_staged
    n_windows = 3
    bursts = [
        synth.bits_to_burst(
            synth.make_scm_bits(meter_id=111111, consumption=1), 2 * w + 200),
        # Straddles a window boundary: recovered only through the carry the
        # native pop updates in place.
        synth.bits_to_burst(
            synth.make_scm_bits(meter_id=222222, consumption=2),
            w - 96 * spec.symbol_length // 2),
    ]
    iq = synth.render_iq(n_windows * w, bursts, 8, noise=2.0, seed=5)
    p = tmp_path / "cap.bin"
    iq.tofile(p)

    want = [(b, str(m)) for b, m in dec.decode_capture(iq)]
    assert len(want) >= 2

    src = native.NativeFileSource(str(p))
    carry = np.zeros(hs, np.uint16)
    py_carry = np.zeros(hs, np.uint16)
    dec2 = small_decoder()
    got = []
    for i in range(n_windows):
        staged = np.zeros(geo.staged_samples, np.uint16)
        n = src.read_staged(staged, carry, w)
        assert n == w
        expect, py_carry = py_staged(spec, iq, i, py_carry)
        assert np.array_equal(staged, expect), f"window {i} staged mismatch"
        assert np.array_equal(carry, py_carry), f"window {i} carry mismatch"
        got.extend((b, str(m)) for b, m in dec2.process_host_staged(staged))
    # End of capture: a partial read leaves carry untouched.
    tail = np.zeros(geo.staged_samples, np.uint16)
    carry_before = carry.copy()
    assert src.read_staged(tail, carry, w) == 0
    assert np.array_equal(carry, carry_before)
    src.close()
    got.extend((b, str(m)) for b, m in dec2.drain())
    assert got == want


def test_ring_read_staged_matches_file():
    """The ring-buffer to-staged pop (live rtl_tcp path) builds the same
    buffers as the port's staging."""
    spec = small_decoder().spec
    geo = staged_geometry(spec)
    w, hs = spec.window, spec.halo_staged
    rng = np.random.default_rng(17)
    iq = rng.integers(0, 256, size=2 * 2 * w, dtype=np.uint8)

    srv = FakeServer(iq.tobytes())
    srv.start()
    c = native.NativeRtlTcpClient(f"127.0.0.1:{srv.port}")
    c.connect()
    carry = np.zeros(hs, np.uint16)
    bufs = []
    for _ in range(2):
        staged = np.zeros(geo.staged_samples, np.uint16)
        n, timed_out = c.read_staged(staged, carry, w, deadline=5.0)
        assert n == w and not timed_out
        bufs.append(staged)
    c.close()

    py_carry = np.zeros(hs, np.uint16)
    for i, staged in enumerate(bufs):
        expect, py_carry = py_staged(spec, iq, i, py_carry)
        assert np.array_equal(staged, expect), f"window {i} mismatch"


def test_native_client_matches_python_client():
    """The native and pure-Python clients produce identical streams."""
    rng = np.random.default_rng(11)
    payload = rng.integers(0, 256, size=64_000, dtype=np.uint8).tobytes()

    srv_n = FakeServer(payload)
    srv_n.start()
    cn = native.NativeRtlTcpClient(f"127.0.0.1:{srv_n.port}")
    cn.connect()
    got_native = cn.read_samples(len(payload), deadline=5.0)
    cn.close()

    srv_p = FakeServer(payload)
    srv_p.start()
    cp = RtlTcpClient(f"127.0.0.1:{srv_p.port}")
    cp.connect()
    got_python = cp.read_samples(len(payload), deadline=5.0)
    cp.close()

    assert np.array_equal(got_native, got_python)


def test_cli_live_with_native_ingest(capsys):
    """End to end: the port's CLI decodes a planted SCM packet over the
    native client."""
    cfg = build_decoder_config([new_parser("scm", 72)])
    bits = synth.make_scm_bits(meter_id=27182818, consumption=9)
    iq = synth.render_iq(
        cfg.block_size * 40,
        [synth.bits_to_burst(bits, cfg.block_size * 3)],
        72,
        noise=2.0,
        seed=13,
    )
    srv = FakeServer(iq.tobytes(), linger=3.0)
    srv.start()
    out = io.StringIO()
    fs = build_flagset()
    fs.parse(["-msgtype=scm", "-format=json", "-ingest=native",
              f"-server=127.0.0.1:{srv.port}", "-single", "-duration=20s",
              "-windowblocks=8"])
    rc = cli_run(fs, out=out, device="cpu")
    assert rc == 0
    assert "27182818" in out.getvalue()
    assert "ingest: native" in capsys.readouterr().err


def test_ring_stress_tsan(tmp_path):
    """Build the SPSC ring stress harness of the port's copy of the source
    under ThreadSanitizer and run it: a producer floods a tiny ring
    (constant drop pressure) while the consumer validates pair alignment,
    ordering and byte conservation, and a third thread hammers size().
    TSAN exits nonzero on any data race."""
    gxx = shutil.which("g++")
    assert gxx is not None, "no g++"
    exe = tmp_path / "ring_stress"
    build = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-g", "-fsanitize=thread",
         "-DRTLAMR_RING_STRESS", native.SRC, "-o", str(exe), "-lpthread"],
        capture_output=True,
    )
    if build.returncode != 0 and b"tsan" in build.stderr.lower():
        pytest.skip("no TSAN runtime in image")
    assert build.returncode == 0, build.stderr.decode()
    run = subprocess.run([str(exe), "1"], capture_output=True, timeout=120)
    assert run.returncode == 0, (run.stdout + run.stderr).decode()
    assert run.stdout.startswith(b"OK"), run.stdout.decode()


# ---------------------------------------------------------------------------
# read_staged into torch tensors


def test_read_staged_into_torch_tensors(tmp_path):
    """File and ring ``read_staged`` into ``torch.uint16`` tensors (staged
    and carry) write what they write into numpy arrays."""
    spec = small_decoder().spec
    geo = staged_geometry(spec)
    w, hs = spec.window, spec.halo_staged
    iq = np.random.default_rng(3).integers(0, 256, size=3 * 2 * w, dtype=np.uint8)
    p = tmp_path / "cap.bin"
    iq.tofile(p)
    srv = FakeServer(iq.tobytes())
    srv.start()
    ring = native.NativeRtlTcpClient(f"127.0.0.1:{srv.port}")
    ring.connect()
    src = native.NativeFileSource(str(p))
    carry_np, carry_t, carry_r = (np.zeros(hs, np.uint16), torch.zeros(hs, dtype=torch.uint16),
                                  torch.zeros(hs, dtype=torch.uint16))
    for i in range(3):
        want = np.zeros(geo.staged_samples, np.uint16)
        got_t = torch.zeros(geo.staged_samples, dtype=torch.uint16)
        got_r = torch.zeros(geo.staged_samples, dtype=torch.uint16)
        src.seek(i * 2 * w)
        assert src.read_staged(want, carry_np, w) == w
        src.seek(i * 2 * w)
        assert src.read_staged(got_t, carry_t, w) == w
        assert ring.read_staged(got_r, carry_r, w, deadline=5.0) == (w, False)
        for got, carry in ((got_t, carry_t), (got_r, carry_r)):
            assert np.array_equal(got.numpy(), want), f"window {i}"
            assert np.array_equal(carry.numpy(), carry_np), f"window {i}"
    ring.close()
    src.close()


def bad_buffers(n: int, hs: int):
    return {
        "dtype_int16_tensor": (torch.zeros(n, dtype=torch.int16), TypeError),
        "dtype_uint8_array": (np.zeros(2 * n, np.uint8), TypeError),
        "short": (torch.zeros(n - 1, dtype=torch.uint16), ValueError),
        "device": (torch.empty(n, dtype=torch.uint16, device="meta"), ValueError),
        "strided": (torch.zeros(2 * n, dtype=torch.uint16)[::2], ValueError),
        "two_dims": (np.zeros((1, n), np.uint16), ValueError),
        "read_only": (np.zeros(n, np.uint16), ValueError),
        "list": (list(range(n)), TypeError),
    }


@pytest.mark.parametrize("case", sorted(bad_buffers(8, 2)))
def test_read_staged_refuses_bad_buffers(case, tmp_path):
    """A staged buffer of the wrong dtype, length, device or layout raises,
    from the file and from the ring, and reads nothing."""
    spec = small_decoder().spec
    w, hs = spec.window, spec.halo_staged
    n = hs + w
    buf, exc = bad_buffers(n, hs)[case]
    if case == "read_only":
        buf.flags.writeable = False
    p = tmp_path / "cap.bin"
    np.zeros(2 * w, np.uint8).tofile(p)
    src = native.NativeFileSource(str(p))
    carry = np.zeros(hs, np.uint16)
    with pytest.raises(exc):
        src.read_staged(buf, carry, w)
    assert src.read(2 * w).size == 2 * w  # nothing was consumed
    if case != "short":  # the same buffer as the carry
        with pytest.raises(exc):
            src.read_staged(np.zeros(n, np.uint16), buf, 1)
    src.close()
    srv = FakeServer(np.zeros(2 * w, np.uint8).tobytes())
    srv.start()
    ring = native.NativeRtlTcpClient(f"127.0.0.1:{srv.port}")
    ring.connect()
    with pytest.raises(exc):
        ring.read_staged(buf, carry, w)
    assert ring.read_samples(2 * w).size == 2 * w
    ring.close()


# ---------------------------------------------------------------------------
# The native file path through process_host_staged


def seeded_capture(spec, windows: int) -> np.ndarray:
    """``windows`` windows and 5.5 blocks of all four protocols, two bursts
    of each in turn, a burst every PacketLength + 1 block, so packets
    straddle window boundaries and the last read is short of a window and of
    a block."""
    cfg = build_decoder_config([new_parser(n, 8) for n in NAMES])
    total = windows * spec.window + 5 * cfg.block_size + cfg.block_size // 2
    bursts, offset, i = [], cfg.block_size // 2, 0
    while offset + cfg.packet_length < total - cfg.block_size:
        kind = NAMES[i // 2 % len(NAMES)]
        if kind == "scm":
            bursts.append(synth.bits_to_burst(
                synth.make_scm_bits(meter_id=100000 + i, consumption=i), offset))
        elif kind == "scm+":
            bursts.append(synth.bits_to_burst(
                synth.make_scmplus_bits(endpoint_id=200000 + i, consumption=i), offset))
        elif kind == "idm":
            bursts.append(synth.bits_to_burst(synth.make_idm_bits(serial=300000 + i), offset))
        else:
            bursts.append(synth.r900_burst(synth.make_r900_symbols(meter_id=500000 + i), offset))
        offset += cfg.packet_length + cfg.block_size
        i += 1
    return synth.render_iq(total, bursts, 8, noise=2.0, seed=41)


def native_ring_decode(dec, path: str, depth: int = 3):
    """The capture at ``path`` through NativeFileSource.read_staged into a
    StagingRing and ``process_host_staged``: (block, str(message))."""
    ring = StagingRing(dec, depth=depth)
    carry = np.zeros(dec.spec.halo_staged, np.uint16)
    src = native.NativeFileSource(path)
    out = []
    try:
        while True:
            buf = ring.acquire()
            got = src.read_staged(buf, carry, dec.spec.window)
            out += ring.submit(got)
            if got < dec.spec.window:
                break
    finally:
        src.close()
    out += dec.drain()
    return [(b, str(m)) for b, m in out]


@pytest.mark.parametrize("max_hits", [256, 1])
def test_native_file_path_matches_jax_process_host_staged(max_hits, tmp_path):
    """The port's native file path (read_staged into torch.uint16 ring
    buffers, process_host_staged) gives exactly the JAX WindowDecoder's
    messages through its process_host_staged on the same seeded capture,
    the short last read decoded as flush decodes it; with one candidate
    slot the windows, two packets each, escalate from the tensor's device
    copy."""
    from rtlamr_tpu.decoder import WindowDecoder as JaxDecoder
    from rtlamr_tpu.protocols import new_parser as jax_parser

    dec = WindowDecoder([new_parser(n, 8) for n in NAMES], window_blocks=48,
                        max_hits=max_hits, device="cpu")
    spec = dec.spec
    w, hs, bs = spec.window, spec.halo_staged, spec.block_size
    iq = seeded_capture(spec, windows=6)
    path = tmp_path / "cap.bin"
    iq.tofile(path)
    got = native_ring_decode(dec, str(path))

    jdec = JaxDecoder([jax_parser(n, 8) for n in NAMES], window_blocks=48,
                      max_hits=max_hits)
    carry = np.zeros(hs, np.uint16)
    want = []
    n_full = iq.size // (2 * w)
    for i in range(n_full):
        staged, carry = py_staged(spec, iq, i, carry)
        want += jdec.process_host_staged(staged)
    tail = iq[n_full * 2 * w :]
    blocks = tail.size // (2 * bs)
    staged = np.zeros(staged_geometry(spec).staged_samples, np.uint16)
    staged[:hs] = carry
    staged[hs : hs + blocks * bs] = tail[: blocks * 2 * bs].view(np.uint16)
    want += jdec.process_host_staged(staged, valid_blocks=blocks)
    want = [(b, str(m)) for b, m in want + jdec.drain()]
    assert len(want) >= 10
    assert got == want
    assert got == [(b, str(m)) for b, m in jdec.decode_capture(iq)]
    assert (dec.metrics.hit_overflows > 0) == (max_hits == 1)
    assert dec.export_state()["carry"].shape == (hs,)


def test_process_host_staged_refuses_bad_tensors():
    dec = small_decoder()
    n = staged_geometry(dec.spec).staged_samples
    for bad in (torch.zeros(n, dtype=torch.int16), torch.zeros(2 * n, dtype=torch.uint16)[::2],
                torch.empty(n, dtype=torch.uint16, device="meta")):
        with pytest.raises(ValueError, match="process_host_staged"):
            dec.process_host_staged(bad)


# ---------------------------------------------------------------------------
# -ingest in the CLI


def receiver(argv):
    fs = build_flagset()
    fs.parse(argv)
    return Receiver(fs, device="cpu")


@pytest.mark.parametrize("mode,cls", [("auto", native.NativeFileSource),
                                      ("native", native.NativeFileSource),
                                      ("python", FileSource)])
def test_ingest_flag_opens_its_source(mode, cls, capsys):
    """``-ingest=auto`` opens the native source when the library builds, as
    the JAX package's CLI does (rtlamr_tpu/cli/main.py:175-190), and logs
    the transport it chose; standard input is read by Python."""
    r = receiver(["-msgtype=scm", "-symbollength=78", f"-ingest={mode}", f"-fromfile={SAMPLE}"])
    src = r.open_source()
    try:
        assert type(src) is cls
    finally:
        src.close()
    chosen = "python" if cls is FileSource else "native"
    assert f"ingest: {chosen} (-ingest={mode})" in capsys.readouterr().err
    assert type(receiver([f"-ingest={mode}", "-fromfile=-"]).open_source()) is StdinSource


def test_ingest_without_the_library(monkeypatch, capsys):
    """When the library does not build, ``-ingest=auto`` takes the Python
    transport and ``-ingest=native`` exits 1 with the build's error; an
    invalid value exits 1."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(native, "load_error", lambda: "g++ failed: test")
    src = receiver(["-ingest=auto", f"-fromfile={SAMPLE}"]).open_source()
    assert type(src) is FileSource
    src.close()
    with pytest.raises(SystemExit) as exc:
        receiver(["-ingest=native", f"-fromfile={SAMPLE}"]).open_source()
    assert exc.value.code == 1
    assert "native ingest unavailable: g++ failed: test" in capsys.readouterr().err
    with pytest.raises(SystemExit) as exc:
        receiver(["-ingest=fast", f"-fromfile={SAMPLE}"])
    assert exc.value.code == 1


def cli_json(argv):
    """(exit code, the JSON records without their Time) of the port's CLI."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv, device="cpu")
    recs = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.strip()]
    for r in recs:
        r.pop("Time")
    return rc, recs


def test_cli_native_equals_python_on_the_golden_capture():
    base = ["-msgtype=scm", "-symbollength=78", "-windowblocks=8", "-format=json",
            f"-fromfile={SAMPLE}"]
    rc_n, native_recs = cli_json(base + ["-ingest=native"])
    rc_p, python_recs = cli_json(base + ["-ingest=python"])
    assert rc_n == rc_p == 0
    assert len(native_recs) == 14 and native_recs == python_recs


# ---------------------------------------------------------------------------
# On the card


@pytest.mark.cuda
def test_cuda_native_file_path(tmp_path):
    """On the card: read_staged into pinned ring buffers, each refilled
    after its copy's event, through K1; the messages equal the feed path's
    on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode stencil kernel runs only there")
    dec = WindowDecoder([new_parser(n, 8) for n in NAMES], window_blocks=24, device=None)
    iq = seeded_capture(dec.spec, windows=12)
    path = tmp_path / "cap.bin"
    iq.tofile(path)
    want = [(b, str(m)) for b, m in dec.decode_capture(iq)]
    assert all(b.is_pinned() for b in StagingRing(dec, depth=2).buffers)
    dec.reset()
    before = decode_stencil.launches
    got = native_ring_decode(dec, str(path), depth=2)
    assert got == want and len(want) >= 10
    assert decode_stencil.launches - before == 13  # 12 windows and the short read
    assert dec.h2d_event is not None and dec.h2d_event.query()
