"""The port's CLI (``python -m rtlamr_tpu_torch``) against the JAX package's:
the same output lines on the golden capture and on a four-channel wideband
capture (``-channels=4``) with the time field masked, the committed golden
encoder fixtures, and a clear exit 1 for the modes this port does not run
yet (``-checkpoint`` runs: tests/test_torch_checkpoint.py; ``-ingest`` and
``-mesh``: tests/test_torch_native.py and tests/test_torch_mesh.py)."""

import contextlib
import datetime
import io
import json
import pathlib
import re
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from rtlamr_tpu.cli.flags import build_flagset as jax_flagset
from rtlamr_tpu.cli.main import run as jax_run
from rtlamr_tpu_torch.cli.encoders import LogMessage, make_encoder
from rtlamr_tpu_torch.cli.main import main
from rtlamr_tpu_torch.protocols import new_parser
from rtlamr_tpu_torch.protocols.base import build_decoder_config
from rtlamr_tpu_torch.protocols.idm import IDM
from rtlamr_tpu_torch.protocols.netidm import NetIDM
from rtlamr_tpu_torch.protocols.r900 import R900
from rtlamr_tpu_torch.protocols.r900bcd import R900BCD
from rtlamr_tpu_torch.protocols.scm import SCM
from rtlamr_tpu_torch.protocols.scmplus import SCMPlus
from rtlamr_tpu_torch.ref import synth

# The suite runs in several worker processes at once; torch's default of one
# intra-op thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

FIXTURES =pathlib.Path(__file__).parent / "fixtures"
SAMPLE = str(FIXTURES / "sample.bin")
GOLDEN_ARGS = ["-msgtype=scm", "-symbollength=78", "-windowblocks=8",
               f"-fromfile={SAMPLE}"]
TIMESTAMP = re.compile(r"\d{4}-\d\d-\d\dT[\d:.]+Z?")


def port_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv, device="cpu")
    return rc, TIMESTAMP.sub("<time>", out.getvalue())


def jax_cli(argv):
    out = io.StringIO()
    fs = jax_flagset()
    fs.parse(argv)
    fs.env_override(log=lambda *a: None)
    rc = jax_run(fs, out=out)
    return rc, TIMESTAMP.sub("<time>", out.getvalue())


@pytest.mark.parametrize(
    "extra",
    [
        ["-format=json"],
        ["-format=plain"],
        ["-format=csv"],
        ["-format=xml"],
        ["-format=plain", "-samplefile=DUMP"],
        ["-format=json", "-single", "-filterid=17580293,17578504"],
        ["-format=csv", "-unique", "-filtertype=8"],
    ],
    ids=["json", "plain", "csv", "xml", "samplefile", "single", "unique"],
)
def test_cli_matches_jax(extra, tmp_path):
    extra = [a.replace("DUMP", str(tmp_path / "dump.bin")) for a in extra]
    rc, got = port_cli(GOLDEN_ARGS + extra)
    jrc, want = jax_cli(GOLDEN_ARGS + [a.replace("dump.bin", "jdump.bin") for a in extra])
    assert rc == jrc == 0
    assert got.splitlines() == want.splitlines()
    assert got.strip()
    if "-samplefile" in " ".join(extra):
        assert (tmp_path / "dump.bin").read_bytes() == (tmp_path / "jdump.bin").read_bytes()


def test_cli_json_golden_messages():
    rc, out = port_cli(GOLDEN_ARGS + ["-format=json", "-duration=0"])
    assert rc == 0
    assert len(out.strip().splitlines()) == 14
    assert '"ID":17580293' in out.splitlines()[0]


TIME = datetime.datetime(2020, 7, 14, 12, 34, 56, 789012)
MESSAGES = {
    "scm": SCM(ID=17580293, Type=8, TamperPhy=2, TamperEnc=1,
               Consumption=111414, ChecksumVal=0xD19E),
    "scmplus": SCMPlus(FrameSync=0x16A3, ProtocolID=0x1E, EndpointType=0xAB,
                       EndpointID=40404040, Consumption=12345678,
                       Tamper=0x0102, PacketCRC=0xBEEF),
    "idm": IDM(Preamble=0x555516A3, PacketTypeID=0x1C, PacketLength=0x5C,
               HammingCode=0xC6, ApplicationVersion=0x04, ERTType=0x07,
               ERTSerialNumber=123456789, ConsumptionIntervalCount=42,
               ModuleProgrammingState=0x9F, TamperCounters=b"ABC123",
               AsynchronousCounters=0x0203, PowerOutageFlags=b"XYZ789",
               LastConsumptionCount=9876543,
               DifferentialConsumptionIntervals=tuple(range(1, 48)),
               TransmitTimeOffset=1234, SerialNumberCRC=0xCAFE,
               PacketCRC=0xF00D),
    "netidm": NetIDM(Preamble=0x555516A3, ProtocolID=0x1C, PacketLength=0x5C,
                     HammingCode=0xC6, ApplicationVersion=0x04, ERTType=0x07,
                     ERTSerialNumber=987654321, ConsumptionIntervalCount=11,
                     ProgrammingState=0x9F, LastGeneration=112233,
                     LastConsumption=445566, LastConsumptionNet=778899,
                     DifferentialConsumptionIntervals=tuple(range(100, 127)),
                     TransmitTimeOffset=777, SerialNumberCRC=0x1234,
                     PacketCRC=0x5678),
    "r900": R900(ID=1550406067, Unkn1=0xA3, NoUse=9, BackFlow=1,
                 Consumption=1234567, Unkn3=0x02, Leak=3, LeakNow=2),
    "r900bcd": R900BCD(ID=1550406067, Unkn1=0xA3, NoUse=9, BackFlow=1,
                       Consumption=123456, Unkn3=0x02, Leak=3, LeakNow=2),
}


@pytest.mark.parametrize("proto", sorted(MESSAGES))
@pytest.mark.parametrize("fmt", ["plain", "csv", "json", "xml"])
def test_encoder_matches_golden_fixture(proto, fmt):
    """The 24 committed fixtures of tests/fixtures/golden_output (the same
    envelope tests/test_golden_output.py renders for the JAX package)."""
    want = (FIXTURES / "golden_output" / f"{proto}.{fmt}.txt").read_text()
    out = io.StringIO()
    enc = make_encoder(fmt, out, sample_filename="dump.bin")
    enc.encode(LogMessage(time=TIME, offset=1234, length=49152, msg=MESSAGES[proto]))
    assert out.getvalue() == want


def test_backend_flag_has_no_effect(capsys):
    rc, out = port_cli(GOLDEN_ARGS + ["-backend=pallas", "-format=json"])
    assert rc == 0 and len(out.strip().splitlines()) == 14
    assert "no effect" in capsys.readouterr().err


def test_version(capsys):
    assert main(["-version"], device="cpu") == 0
    assert "rtlamr_tpu_torch" in capsys.readouterr().out


def test_profiledir_writes_a_trace(tmp_path):
    rc, out = port_cli(GOLDEN_ARGS + ["-format=json", f"-profiledir={tmp_path}"])
    assert rc == 0 and len(out.strip().splitlines()) == 14
    assert (tmp_path / "trace.json").stat().st_size > 0


class FakeRtlTcp(threading.Thread):
    """A local rtl_tcp server: sends the dongle header, then streams IQ while
    recording the 5-byte tuner commands it receives."""

    def __init__(self, iq_bytes: np.ndarray):
        super().__init__(daemon=True)
        self.iq = np.asarray(iq_bytes, np.uint8).tobytes()
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(1)
        self.port = self.sock.getsockname()[1]
        self.commands = []

    def run(self):
        conn, _ = self.sock.accept()
        conn.sendall(b"RTL0" + struct.pack(">II", 5, 29))  # R820T, 29 gains
        conn.settimeout(0.1)
        pos, cmd = 0, b""
        deadline = time.time() + 15.0
        try:
            while time.time() < deadline:
                try:
                    data = conn.recv(64)
                    if not data:
                        break  # the client closed
                    cmd += data
                    while len(cmd) >= 5:
                        self.commands.append(struct.unpack(">BI", cmd[:5]))
                        cmd = cmd[5:]
                except socket.timeout:
                    pass
                if pos < len(self.iq):
                    end = min(pos + 65536, len(self.iq))
                    conn.sendall(self.iq[pos:end])
                    pos = end
        except (BrokenPipeError, ConnectionResetError):
            pass
        finally:
            conn.close()
            self.sock.close()


@pytest.mark.parametrize("latency", [False, True])
def test_live_rtltcp_roundtrip(latency):
    """Connect, tune, stream, decode and stop at the first message, in the
    throughput and the -latency presets."""
    cfg = build_decoder_config([new_parser("scm", 72)])
    bits = synth.make_scm_bits(meter_id=31415926, consumption=123)
    iq = synth.render_iq(
        cfg.block_size * 40, [synth.bits_to_burst(bits, cfg.block_size * 3)],
        72, noise=2.0, seed=5,
    )
    server = FakeRtlTcp(iq)
    server.start()
    argv = ["-msgtype=scm", f"-server=127.0.0.1:{server.port}", "-single=true",
            "-duration=12s", "-format=json", "-biastee=true"]
    # more than one 256 KiB read of the throughput preset, or its first read
    # times out
    argv += ["-latency"] if latency else ["-windowblocks=16"]
    rc, out = port_cli(argv)
    server.join(timeout=5)
    assert rc == 0
    rec = json.loads(out.strip().splitlines()[0])
    assert rec["Message"]["ID"] == 31415926
    assert rec["Message"]["Consumption"] == 123
    cmds = dict(server.commands)
    assert cmds.get(0x01) == 912600155  # SCM center frequency
    assert cmds.get(0x02) == 32768 * 72  # derived sample rate
    assert 0x03 in cmds  # gain mode (auto)
    assert cmds.get(0x0E) == 1  # bias tee


# ---------------------------------------------------------------------------
# Wideband CLI (-channels N), mirroring tests/test_cli.py's wideband cases


WIDEBAND_ARGS = ["-msgtype=all", "-symbollength=8", "-channels=4", "-windowblocks=24"]


@pytest.fixture(scope="module")
def wideband_capture(tmp_path_factory):
    """tests/test_cli.py ``_wideband_capture``: four channels at chip length
    8, one packet on each, written to a file."""
    window = 24 * build_decoder_config([new_parser(n, 8) for n in
                                        ("scm", "scm+", "idm", "r900")]).block_size
    planted = [
        (0, synth.bits_to_burst(synth.make_scm_bits(meter_id=111001, consumption=1), 3000)),
        (1, synth.bits_to_burst(synth.make_scm_bits(meter_id=222002, consumption=2),
                                window - 700)),
        (2, synth.r900_burst(synth.make_r900_symbols(meter_id=333003), 5000)),
        (3, synth.bits_to_burst(synth.make_idm_bits(serial=444004), 300)),
    ]
    wb = synth.render_wideband(3 * window, planted, 4, 8, amplitude=90.0, noise=2.0, seed=21)
    path = tmp_path_factory.mktemp("wideband") / "wideband.bin"
    wb.tofile(path)
    return wb, str(path)


def test_cli_wideband_matches_jax(wideband_capture, capsys):
    """-channels=4 JSON lines equal the JAX CLI's; the channel plan is
    logged at startup."""
    argv = WIDEBAND_ARGS + ["-format=json", f"-fromfile={wideband_capture[1]}"]
    rc, got = port_cli(argv)
    err = capsys.readouterr().err
    jrc, want = jax_cli(argv)
    assert rc == jrc == 0
    assert got.splitlines() == want.splitlines()
    recs = [json.loads(ln) for ln in got.splitlines()]
    assert list(recs[0]) == ["Time", "Offset", "Length", "Channel", "Type", "Message"]
    assert {(r["Channel"], r["Message"].get("ID", r["Message"].get("ERTSerialNumber")))
            for r in recs} >= {(0, 111001), (1, 222002), (2, 333003), (3, 444004)}
    assert "wideband: 4 channels" in err
    assert "channel 3:" in err


def test_cli_wideband_plain_and_dedup(wideband_capture):
    """The plain format carries the Channel: tag; -crosschanneldedup parses
    and gives the JAX CLI's lines."""
    argv = WIDEBAND_ARGS + ["-crosschanneldedup=true", f"-fromfile={wideband_capture[1]}"]
    rc, got = port_cli(argv)
    jrc, want = jax_cli(argv)
    assert rc == jrc == 0
    lines = got.strip().splitlines()
    assert lines and all("Channel:" in ln for ln in lines)
    assert got.splitlines() == want.splitlines()


def test_cli_wideband_live_tunes_wideband_rate(wideband_capture):
    """Live wideband: the rtl_tcp tuner is set to channels x samplerate."""
    server = FakeRtlTcp(wideband_capture[0])
    server.start()
    rc, out = port_cli(WIDEBAND_ARGS + [
        "-format=json", f"-server=127.0.0.1:{server.port}", "-single=true", "-duration=12s"])
    server.join(timeout=5)
    assert rc == 0
    lines = out.strip().splitlines()
    assert len(lines) >= 1
    assert json.loads(lines[0])["Channel"] in range(4)
    cmds = dict(server.commands)
    assert cmds.get(0x02) == 4 * 32768 * 8  # wideband sample rate


def test_cli_wideband_dedup_keeps_the_lowest_channel(wideband_capture):
    """-crosschanneldedup keeps the lowest channel's copy of a packet seen
    in the same or adjacent block (rtlamr_tpu/parallel/wideband.py:55-83).
    On this capture the R900 burst planted on channel 2 also decodes on
    channel 0, so the copy kept is channel 0's, in the JAX CLI as in the
    port."""
    argv = WIDEBAND_ARGS + ["-format=json", "-crosschanneldedup=true",
                            f"-fromfile={wideband_capture[1]}"]
    rc, got = port_cli(argv)
    jrc, want = jax_cli(argv)
    assert rc == jrc == 0 and got.splitlines() == want.splitlines()
    recs = [json.loads(ln) for ln in got.splitlines()]
    ids = sorted((r["Channel"], r["Message"].get("ID", r["Message"].get("ERTSerialNumber")))
                 for r in recs)
    assert ids == [(0, 111001), (0, 333003), (1, 222002), (3, 444004)]
