"""The port's multi-host decoder (rtlamr_tpu_torch/parallel/distributed.py,
``-coordinator`` in its CLI) in two and four gloo processes on the CPU, each
with CPU devices (the plain versions):

- per process, the (block, message) stream equals the JAX package's
  ``MultiHostDecoder``'s, run as tests/test_multihost.py runs it
  (tools/multihost_worker.py), in the ``basic`` (2 and 4 processes) and
  ``hard`` scenarios, on captures from the worker's own capture functions; the
  ``overflow`` and ``allproto`` scenarios' union equals the JAX
  ``WindowDecoder``'s single-process stream;
- the CLI entry, ``-single`` and ``-duration`` (stopping together), and a
  two-process interrupt/resume that is bit identical, also when the stop
  falls after the last, partial super-batch;
- the ``.pN`` checkpoint files both ways with the JAX package's
  ``MultiHostCheckpoint`` (built as a dataclass, no process group), and an
  interrupted save that leaves the previous set whole.

Each port process is this file run as a script (the ``__main__`` block at
the end). Every subprocess has its own timeout; ports come from a socket
bound and closed. The ``cuda`` test (two processes, a card each) runs on a
machine with two or more cards:
``python -m pytest --noconftest tests/test_torch_distributed.py -m cuda``."""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
THIS = pathlib.Path(__file__).resolve()
CHIP = 8
TIMEOUT = 240  # seconds, each subprocess


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def child_env(**extra) -> dict:
    """The environment of a worker: the repo importable, one torch thread,
    the pytest process's JAX platform flags dropped (JAX workers build their
    own CPU backends)."""
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = str(ROOT) + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra)
    return env


def run_procs(cmds, env=None, cwd=ROOT):
    """Start every command, wait for all (each within TIMEOUT, all killed on
    a timeout); (stdout, stderr) of each. A failed process fails the test."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=cwd,
                              env=env or child_env()) for c in cmds]
    outs = []
    try:
        for i, proc in enumerate(procs):
            try:
                o, e = proc.communicate(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                pytest.fail(f"process {i} timed out")
            assert proc.returncode == 0, f"process {i} failed:\n{e.decode()[-3000:]}"
            outs.append((o.decode(), e.decode()))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


def run_workers(tmp_path, package, scenario, num_procs=2, devs=2, scan_windows=2):
    """The JAX package's worker (tools/multihost_worker.py) or the port's
    (this file), one process each; their JSON results in process order."""
    coordinator = f"127.0.0.1:{free_port()}"
    outs = [tmp_path / f"{package}{p}.json" for p in range(num_procs)]
    script = ROOT / "tools" / "multihost_worker.py" if package == "jax" else THIS
    run_procs([[sys.executable, str(script), coordinator, str(num_procs), str(p), str(outs[p]),
                str(devs), str(scan_windows), scenario] for p in range(num_procs)])
    return [json.loads(o.read_text()) for o in outs]


def streams(results):
    return [[(m["block"], m["text"]) for m in r["messages"]] for r in results]


@pytest.mark.parametrize("scenario,num_procs,devs", [("basic", 2, 2), ("basic", 4, 1),
                                                     ("hard", 2, 2), ("resume", 2, 2)])
def test_matches_jax_multihost_per_process(tmp_path, scenario, num_procs, devs):
    """Each process's stream equals the JAX MultiHostDecoder's process's:
    the seam packet once, through the halo ring; in ``hard`` the overflow
    storm at the process seam escalates from the true halo and the
    plateau across the super-batch boundary dedups through the wrap; in
    ``resume`` the same capture goes through a checkpoint and a fresh
    decoder between the two super-batches."""
    port = run_workers(tmp_path, "torch", scenario, num_procs, devs)
    jax = run_workers(tmp_path, "jax", scenario, num_procs, devs)
    assert streams(port) == streams(jax)
    ids = sorted(m["id"] for r in port for m in r["messages"])
    if scenario in ("hard", "resume"):
        assert ids == [111111, 222222, 444444, 555555, 666666]
        assert any(r["metrics"]["hit_overflows"] > 0 for r in port)
    else:
        assert ids == [111111, 222222, 333333]
    assert all(r["metrics"]["superbatches"] == (1 if scenario == "basic" else 2) for r in port)
    if scenario == "resume":
        assert len(list(tmp_path.glob("torch*.json.ckpt.p*.meta.json"))) == num_procs


def jax_window_stream(names, iq):
    from rtlamr_tpu.decoder import WindowDecoder as JaxWindow
    from rtlamr_tpu.protocols import new_parser as jax_parser

    dec = JaxWindow([jax_parser(x, CHIP) for x in names], window_blocks=None)
    return sorted((b, str(m)) for b, m in dec.decode_capture(iq))


@pytest.mark.parametrize("scenario", ["overflow", "allproto"])
def test_union_equals_jax_window_decoder(tmp_path, scenario):
    """Every protocol, and two digests a boundary block (R900 + R900BCD; no
    capacity in the port's seam exchange to overflow): the processes'
    union equals the JAX WindowDecoder's single-process stream."""
    from rtlamr_tpu_torch.decoder import WindowDecoder
    from rtlamr_tpu_torch.protocols import new_parser
    from tools.multihost_worker import build_capture_allproto, build_capture_overflow

    names = WORKER_NAMES[scenario]
    port = run_workers(tmp_path, "torch", scenario)
    dec = WindowDecoder([new_parser(x, CHIP) for x in names], window_blocks=None, device="cpu")
    cfg, spec = dec.cfg, dec.spec
    n_windows = 2 * 2 * 2
    iq = (build_capture_overflow(cfg, spec.window, n_windows, CHIP, spec.halo)
          if scenario == "overflow" else build_capture_allproto(cfg, spec.window, n_windows, CHIP))
    got = sorted(x for s in streams(port) for x in s)
    assert got == jax_window_stream(names, iq)
    assert len(got) >= 6


# ---------------------------------------------------------------------------
# The CLI


def cli_procs(tmp_path, cap, extra, num_procs=2, env=None, code=None):
    """``python -m rtlamr_tpu_torch -coordinator=... -procid=p`` in
    ``num_procs`` processes with two CPU devices each (or ``code``, a
    ``python -c`` program that runs the same CLI); their (stdout, stderr)."""
    coordinator = f"127.0.0.1:{free_port()}"
    argv = ["-msgtype=scm", "-symbollength=8", "-windowblocks=4", f"-coordinator={coordinator}",
            f"-numprocs={num_procs}", "-cpudevices=2", f"-fromfile={cap}", "-format=json"] + extra
    head = [sys.executable, "-c", code] if code else [sys.executable, "-m", "rtlamr_tpu_torch"]
    return run_procs([head + argv + [f"-procid={p}"] for p in range(num_procs)], env=env)


def records(out: str):
    """(ID, Offset, Length) of each JSON record of a CLI's stdout."""
    recs = [json.loads(ln) for ln in out.splitlines() if ln.startswith('{"Time"')]
    return [(r["Message"]["ID"], r["Offset"], r["Length"]) for r in recs]


def window_decoder_blocks(iq, window_blocks=4):
    from rtlamr_tpu_torch.decoder import WindowDecoder
    from rtlamr_tpu_torch.protocols import new_parser

    dec = WindowDecoder([new_parser("scm", CHIP)], window_blocks=window_blocks, device="cpu")
    return [(m.meter_id(), b * dec.cfg.block_size2, dec.cfg.block_size2)
            for b, m in dec.decode_capture(iq)]


def basic_capture(n_batches=1):
    """The JAX CLI tests' capture: tools/multihost_worker.py build_capture at
    4-block windows over one super-batch (2 processes x 2 devices x 2
    windows), ``n_batches`` times over."""
    from rtlamr_tpu_torch.decoder import WindowDecoder
    from rtlamr_tpu_torch.protocols import new_parser
    from tools.multihost_worker import build_capture

    cfg = WindowDecoder([new_parser("scm", CHIP)], window_blocks=4, device="cpu").cfg
    iq = build_capture(cfg, 4 * cfg.block_size, 2 * 2 * 2, CHIP)
    return np.concatenate([iq] * n_batches)


def test_cli_entry_partitions_the_plain_stream(tmp_path):
    """Two processes of the CLI: each emits its own windows' messages, with
    Offset = global block x block bytes; together they are the plain
    decoder's stream, the seam packet once, and the JAX CLI's test's IDs."""
    iq = basic_capture()
    cap = tmp_path / "mh.bin"
    iq.tofile(cap)
    outs = cli_procs(tmp_path, cap, ["-metrics"])
    per = [records(o) for o, _ in outs]
    assert all(per) and sorted(per[0] + per[1], key=lambda r: r[1]) == window_decoder_blocks(iq)
    assert sorted(r[0] for r in per[0] + per[1]) == [111111, 222222, 333333]
    assert max(r[1] for r in per[0]) < min(r[1] for r in per[1])
    for p, (_, err) in enumerate(outs):
        assert f"multi-host: process {p} of 2, 2 local devices, 4 in all" in err
        assert "'superbatches': 1" in err and "ring_exchange_ms" in err


def test_cli_single_stops_early(tmp_path):
    """-single: the processes agree after the first super-batch (it holds
    a message) and both exit 0; the second copy of the capture is never
    decoded."""
    iq = basic_capture(2)
    cap = tmp_path / "mh_single.bin"
    iq.tofile(cap)
    outs = cli_procs(tmp_path, cap, ["-single=true"])
    got = [r for o, _ in outs for r in records(o)]
    ids = sorted(i for i, _, _ in got)
    assert 1 <= len(ids) <= 3 and set(ids) <= {111111, 222222, 333333}
    # Offsets are the capture's byte offsets of the messages' blocks, in the
    # first half (the first super-batch).
    assert all(off % length == 0 and 0 <= off < iq.size // 2 for _, off, length in got)


def test_cli_duration_stops_early(tmp_path):
    """-duration=1ms: every process logs the time limit after the first
    super-batch and exits 0 with at most one batch's messages."""
    iq = basic_capture(6)
    cap = tmp_path / "mh_dur.bin"
    iq.tofile(cap)
    outs = cli_procs(tmp_path, cap, ["-duration=1ms"])
    assert all("time limit reached" in e for _, e in outs)
    assert sum(len(records(o)) for o, _ in outs) <= 3


def test_cli_refusals(tmp_path):
    """-coordinator needs -fromfile; the flags it does not run are named."""
    from rtlamr_tpu_torch.cli.main import main

    assert main(["-coordinator=127.0.0.1:1", "-numprocs=1"], device="cpu") == 1


#: raises SIGINT in process 0 during its ``stop``-th super-batch, then runs
#: the CLI with the remaining arguments
INTERRUPTING_CLI = """
import signal, sys
from rtlamr_tpu_torch.cli.main import main
from rtlamr_tpu_torch.parallel.distributed import MultiHostDecoder
stop = int(sys.argv[1])
orig = MultiHostDecoder.decode_superbatch_local
calls = []
def step(self, *args, **kwargs):
    calls.append(1)
    if len(calls) == stop and self.process_id == 0:
        signal.raise_signal(signal.SIGINT)
    return orig(self, *args, **kwargs)
MultiHostDecoder.decode_superbatch_local = step
sys.exit(main(sys.argv[2:]))
"""


@pytest.mark.parametrize("stop", [2, 3], ids=["mid_capture", "after_last_partial"])
def test_cli_interrupt_resume_bit_identical(tmp_path, stop):
    """SIGINT on process 0 during super-batch ``stop`` of a ``-checkpoint``
    run: both processes stop after it and save their file sets at the byte
    boundary consumed; the resumed run emits the rest, so the two runs'
    records equal the straight run's. With ``stop`` = 3 the stop follows the
    last, partial super-batch (2.5 super-batches): the checkpoint holds the
    capture's end, and the resumed run decodes nothing again (the JAX CLI
    resumes at the floor of that boundary and decodes the last super-batch
    twice)."""
    iq = basic_capture(2)
    iq = np.concatenate([iq, iq[: iq.size // 4]])
    cap = tmp_path / "mh_ck.bin"
    iq.tofile(cap)
    ck = tmp_path / "ck"
    want = [records(o) for o, _ in cli_procs(tmp_path, cap, [])]
    assert not list(tmp_path.glob("ck.p*"))
    code = INTERRUPTING_CLI
    head = cli_procs(tmp_path, cap, [f"-checkpoint={ck}"], code=code.replace(
        "int(sys.argv[1])", str(stop)).replace("sys.argv[2:]", "sys.argv[1:]"))
    assert all("interrupted" in e and "checkpoint saved at byte" in e for _, e in head)
    assert sorted(p.name for p in tmp_path.glob("ck.p*.meta.json")) == [
        "ck.p0.meta.json", "ck.p1.meta.json"]
    tail = cli_procs(tmp_path, cap, [f"-checkpoint={ck}"])
    boundary = {e.split("resumed from checkpoint at byte ")[1].split()[0] for _, e in tail}
    assert len(boundary) == 1
    for p in range(2):
        assert records(head[p][0]) + records(tail[p][0]) == want[p]
    if stop == 3:
        assert int(boundary.pop()) == iq.size and not any(records(o) for o, _ in tail)
    assert not list(tmp_path.glob("ck.p*"))  # a run to the end deletes them


# ---------------------------------------------------------------------------
# Checkpoint files


def multihost_fields(process_id=1, first=False):
    rng = np.random.default_rng(process_id)
    return dict(
        byte_offset=262144, window_index=16, first=first, last_block=63,
        carry_local=None if first else rng.integers(0, 1 << 16, (2, 1616), dtype=np.uint16),
        prev_digests=[("SCM", 7, 111111, b"\x12\x34"), ("R900", 0, 5, b"\xab\xcd\xef")],
        prev_batch_tail=(31, sorted([b"\x01" * 8, b"\x02" * 8])),
        num_processes=2, process_id=process_id, n_global=4, scan_windows=2, window=2048)


@pytest.mark.parametrize("first", [False, True])
def test_multihost_files_round_trip_with_jax(tmp_path, first):
    """The port writes the JAX package's .pN file set and reads its: every
    field of each, a stream head (no carry) included."""
    from rtlamr_tpu.decoder.checkpoint import MultiHostCheckpoint as JaxMH
    from rtlamr_tpu_torch.decoder.checkpoint import MultiHostCheckpoint, checkpoint_exists

    fields = multihost_fields(first=first)
    path = str(tmp_path / "mh")
    MultiHostCheckpoint(**fields).save(path)
    assert checkpoint_exists(path)
    theirs = JaxMH.load(path, 1)
    JaxMH(**fields).save(str(tmp_path / "jx"))
    ours = MultiHostCheckpoint.load(str(tmp_path / "jx"), 1)
    for got in (theirs, ours):
        for name, value in fields.items():
            have = getattr(got, name)
            if isinstance(value, np.ndarray):
                assert np.array_equal(np.asarray(have).reshape(value.shape), value)
            elif name == "prev_batch_tail":
                assert (have[0], sorted(have[1])) == value
            elif name == "prev_digests":
                assert sorted(map(tuple, have)) == sorted(value)
            else:
                assert have == value, name
    with pytest.raises(FileNotFoundError):
        MultiHostCheckpoint.load(path, 0)


def test_load_checkpoint_names_the_multihost_sets(tmp_path):
    from rtlamr_tpu_torch.decoder.checkpoint import MultiHostCheckpoint, load_checkpoint

    path = str(tmp_path / "mh")
    MultiHostCheckpoint(**multihost_fields(process_id=0)).save(path)
    with pytest.raises(ValueError, match="multi-host.*-coordinator"):
        load_checkpoint(path)


def test_interrupted_save_leaves_the_old_set_whole(tmp_path, monkeypatch):
    """A save that dies between its two files (the carry moved in, the meta
    not) leaves the previous set readable and whole."""
    from rtlamr_tpu_torch.decoder import checkpoint as ck

    path = str(tmp_path / "mh")
    old = multihost_fields()
    ck.MultiHostCheckpoint(**old).save(path)
    new = dict(old, byte_offset=524288, window_index=24,
               carry_local=old["carry_local"] ^ np.uint16(0xFFFF))
    real = os.replace

    def fail_on_meta(src, dst):
        if dst.endswith(".meta.json"):
            raise OSError("disk full")
        return real(src, dst)

    with monkeypatch.context() as mp:
        mp.setattr(ck.os, "replace", fail_on_meta)
        with pytest.raises(OSError):
            ck.MultiHostCheckpoint(**new).save(path)
    got = ck.MultiHostCheckpoint.load(path, 1)
    assert got.byte_offset == old["byte_offset"]
    assert np.array_equal(got.carry_local.reshape(2, -1), old["carry_local"])
    ck.MultiHostCheckpoint(**new).save(path)
    assert ck.MultiHostCheckpoint.load(path, 1).byte_offset == 524288


def test_digest_hash_is_the_jax_packages():
    from rtlamr_tpu.parallel.distributed import _digest_hash as jax_hash
    from rtlamr_tpu_torch.decoder import WindowDecoder
    from rtlamr_tpu_torch.parallel.distributed import _digest_hash
    from rtlamr_tpu_torch.protocols import new_parser
    from rtlamr_tpu_torch.protocols.base import digest

    iq = basic_capture()
    msgs = WindowDecoder([new_parser("scm", CHIP)], window_blocks=4,
                         device="cpu").decode_capture(iq)
    assert len(msgs) == 3
    for _, m in msgs:
        assert _digest_hash(digest(m)) == bytes(jax_hash(digest(m)))


# ---------------------------------------------------------------------------
# On the card


@pytest.mark.cuda
def test_cuda_two_processes_a_card_each(tmp_path):
    """Two processes with a card each (CUDA_VISIBLE_DEVICES), through K1:
    the ``hard`` scenario's streams equal the port's on the CPU."""
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 2:
        pytest.skip("needs two CUDA cards: one process on each")
    coordinator = f"127.0.0.1:{free_port()}"
    outs = [tmp_path / f"card{p}.json" for p in range(2)]
    cmds = [[sys.executable, str(THIS), coordinator, "2", str(p), str(outs[p]), "0", "2", "hard"]
            for p in range(2)]
    procs = [subprocess.Popen(c, cwd=ROOT, env=child_env(CUDA_VISIBLE_DEVICES=str(p)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for p, c in enumerate(cmds)]
    for i, proc in enumerate(procs):
        _, e = proc.communicate(timeout=TIMEOUT)
        assert proc.returncode == 0, f"process {i}:\n{e.decode()[-3000:]}"
    card = [json.loads(o.read_text()) for o in outs]
    assert all(r["devices"] == ["cuda:0"] and r["launches_k1"] > 0 for r in card)
    cpu = run_workers(tmp_path, "torch", "hard", 2, 1)
    assert streams(card) == streams(cpu)
    ids = sorted(m["id"] for r in card for m in r["messages"])
    assert ids == [111111, 222222, 444444, 555555, 666666]


# ---------------------------------------------------------------------------
# The worker: tools/multihost_worker.py's scenarios on the port

WORKER_NAMES = {
    "overflow": ("r900", "r900bcd"),
    "allproto": ("scm", "scm+", "idm", "netidm", "r900", "r900bcd"),
}


def worker(coordinator, num_procs, proc_id, out_path, devs, scan_windows, scenario):
    """tools/multihost_worker.py ``main`` for the port: this process's
    segment of the scenario's capture through MultiHostDecoder on ``devs``
    CPU devices (0: every visible card), the ``resume`` scenario through a
    checkpoint between its super-batches; the records and metrics as JSON."""
    import torch

    torch.set_num_threads(1)
    from rtlamr_tpu_torch.decoder.checkpoint import (
        MultiHostCheckpoint,
        capture_checkpoint,
        restore_checkpoint,
    )
    from rtlamr_tpu_torch.ops.stencil import decode_stencil
    from rtlamr_tpu_torch.parallel.distributed import MultiHostDecoder, initialize
    from rtlamr_tpu_torch.protocols import new_parser
    from tools import multihost_worker as jw

    devices = initialize(coordinator, num_procs, proc_id, cpu_devices_per_process=devs or None)
    parsers = [new_parser(x, CHIP) for x in WORKER_NAMES.get(scenario, ("scm",))]
    max_hits = 1 if scenario in ("hard", "resume") else 256
    n_batches = 2 if scenario in ("hard", "resume") else 1

    def make():
        return MultiHostDecoder(parsers, window_blocks=None, scan_windows=scan_windows,
                                max_hits=max_hits, devices=devices)

    dec = make()
    cfg, w = dec.cfg, dec.spec.window
    batch_windows = dec.n_global * scan_windows
    if scenario in ("hard", "resume"):
        iq = jw.build_capture_hard(cfg, w, batch_windows, n_batches, CHIP, dec.spec.halo)
    elif scenario == "overflow":
        iq = jw.build_capture_overflow(cfg, w, batch_windows, CHIP, dec.spec.halo)
    elif scenario == "allproto":
        iq = jw.build_capture_allproto(cfg, w, batch_windows, CHIP)
    else:
        iq = jw.build_capture(cfg, w, batch_windows, CHIP)
    msgs, prior = [], {}
    for j in range(n_batches):
        lo = j * num_procs * dec.local_window_bytes + proc_id * dec.local_window_bytes
        msgs.extend(dec.decode_superbatch_local(iq[lo : lo + dec.local_window_bytes]))
        if scenario == "resume" and j == 0:
            msgs.extend(dec.drain())
            capture_checkpoint(dec, num_procs * dec.local_window_bytes).save(out_path + ".ckpt")
            prior = dec.metrics.snapshot()
            dec = make()
            restore_checkpoint(dec, MultiHostCheckpoint.load(out_path + ".ckpt", proc_id))
    msgs.extend(dec.drain())
    with open(out_path, "w") as f:
        json.dump({"process": proc_id,
                   "messages": [{"block": b, "type": m.msg_type(), "id": m.meter_id(),
                                 "text": str(m)} for b, m in msgs],
                   # the counters of both decoders of the resume scenario
                   "metrics": {k: v + prior.get(k, 0) if isinstance(v, (int, float)) else v
                               for k, v in dec.metrics.snapshot().items()},
                   "devices": [str(d) for d in dec.devices],
                   "launches_k1": decode_stencil.launches}, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    args = sys.argv[1:]
    worker(args[0], int(args[1]), int(args[2]), args[3], int(args[4]), int(args[5]), args[6])
