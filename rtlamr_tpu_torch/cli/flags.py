"""Go-style flag parsing with the reference's full flag surface.

Mirrors flags.go: single-dash ``-name=value`` / ``-name value`` syntax,
bool flags without arguments, comma-separated map-valued flags
(StringMap/UintMap, flags.go:173-224), ``RTLAMR_<NAME>`` environment
overrides for flags not set on the command line (flags.go:107-122), and the
usage split between rtlamr and rtl_tcp flags (flags.go:72-104).
"""

from __future__ import annotations

import os
import re
import sys
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set

_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h)")
_DURATION_UNITS = {
    "ns": 1e-9,
    "us": 1e-6,
    "µs": 1e-6,
    "ms": 1e-3,
    "s": 1.0,
    "m": 60.0,
    "h": 3600.0,
}


def parse_duration(s: str) -> float:
    """Go-style duration ("1h5m10s") in seconds (flags.go:46)."""
    if s in ("0", ""):
        return 0.0
    neg = s.startswith("-")
    if neg:
        s = s[1:]
    pos = 0
    total = 0.0
    for m in _DURATION_RE.finditer(s):
        if m.start() != pos:
            raise ValueError(f"invalid duration {s!r}")
        total += float(m.group(1)) * _DURATION_UNITS[m.group(2)]
        pos = m.end()
    if pos != len(s):
        raise ValueError(f"invalid duration {s!r}")
    return -total if neg else total


@dataclass
class Flag:
    name: str
    default: str
    usage: str
    kind: str  # "string" | "bool" | "int" | "duration" | "stringset" | "uintset"
    rtlamr: bool  # True: rtlamr flag; False: rtl_tcp flag (flags.go:72-84)
    value: object = None
    set_explicitly: bool = False

    def parse(self, raw: str) -> None:
        if self.kind == "string":
            self.value = raw
        elif self.kind == "bool":
            if raw.lower() not in ("true", "false", "1", "0", "t", "f"):
                raise ValueError(f"invalid boolean value {raw!r} for -{self.name}")
            self.value = raw.lower() in ("true", "1", "t")
        elif self.kind == "int":
            self.value = int(raw, 0)
        elif self.kind == "duration":
            self.value = parse_duration(raw)
        elif self.kind == "stringset":
            # StringMap.Set: replaces defaults (flags.go:183-199)
            self.value = {v.lower() for v in raw.split(",")}
        elif self.kind == "uintset":
            vals = set()
            for v in raw.split(","):
                vals.add(int(v))  # UintMap.Set (flags.go:211-224)
            value = self.value if self.set_explicitly else set()
            self.value = value | vals
        else:
            raise AssertionError(self.kind)
        self.set_explicitly = True


class FlagSet:
    def __init__(self, prog: str = "rtlamr"):
        self.prog = prog
        self.flags: Dict[str, Flag] = {}

    def add(self, name, default, usage, kind="string", rtlamr=True):
        f = Flag(name, str(default), usage, kind, rtlamr)
        # initialize value from default
        if kind == "string":
            f.value = str(default)
        elif kind == "bool":
            f.value = bool(default) if isinstance(default, bool) else default == "true"
        elif kind == "int":
            f.value = int(default)
        elif kind == "duration":
            f.value = parse_duration(str(default))
        elif kind == "stringset":
            f.value = set(default) if not isinstance(default, str) else (
                {default} if default else set()
            )
        elif kind == "uintset":
            f.value = set()
        self.flags[name] = f
        return f

    def usage(self, out=sys.stderr) -> None:
        print(f"Usage of {self.prog}:", file=out)
        for f in self.flags.values():
            if f.rtlamr:
                print(f"  -{f.name}={f.default}: {f.usage}", file=out)
        print(file=out)
        print("rtltcp specific:", file=out)
        for f in self.flags.values():
            if not f.rtlamr:
                print(f"  -{f.name}={f.default}: {f.usage}", file=out)

    def parse(self, argv: Sequence[str]) -> List[str]:
        """Go flag.Parse semantics; returns positional remainder."""
        i = 0
        argv = list(argv)
        while i < len(argv):
            arg = argv[i]
            if arg == "--":
                return argv[i + 1 :]
            if not arg.startswith("-") or arg == "-":
                return argv[i:]
            name = arg.lstrip("-")
            raw: Optional[str] = None
            if "=" in name:
                name, raw = name.split("=", 1)
            if name in ("h", "help"):
                self.usage()
                raise SystemExit(2)
            if name not in self.flags:
                raise SystemExit(f"flag provided but not defined: -{name}")
            f = self.flags[name]
            if raw is None:
                if f.kind == "bool":
                    raw = "true"
                else:
                    i += 1
                    if i >= len(argv):
                        raise SystemExit(f"flag needs an argument: -{name}")
                    raw = argv[i]
            try:
                f.parse(raw)
            except ValueError as e:
                raise SystemExit(str(e))
            i += 1
        return []

    def env_override(self, log=print) -> None:
        """RTLAMR_<NAME> overrides for unset flags (flags.go:107-122)."""
        for f in self.flags.values():
            env_name = "RTLAMR_" + f.name.upper()
            raw = os.environ.get(env_name, "")
            if raw and not f.set_explicitly:
                try:
                    f.parse(raw)
                    log(
                        f"Environment variable {env_name!r} overrides flag "
                        f"{f.name!r} with {raw!r}"
                    )
                except ValueError as e:
                    log(
                        f"Environment variable {env_name!r} failed to "
                        f"override flag {f.name!r} with value {raw!r}: {e}"
                    )

    def __getitem__(self, name: str) -> Flag:
        return self.flags[name]

    def value(self, name: str):
        return self.flags[name].value


VALID_SYMBOL_LENGTHS = (8, 32, 40, 48, 56, 64, 72, 80, 88, 96)


def build_flagset() -> FlagSet:
    fs = FlagSet()
    # rtlamr flags (flags.go:36-84)
    fs.add("samplefile", os.devnull, "raw signal dump file")
    fs.add(
        "msgtype",
        "scm",
        "comma-separated list of message types to receive: all, scm, scm+, "
        "idm, netidm, r900 and r900bcd",
        kind="stringset",
    )
    fs.add(
        "symbollength",
        72,
        "symbol length in samples (8, 32, 40, 48, 56, 64, 72, 80, 88, 96)",
        kind="int",
    )
    fs.add(
        "duration",
        "0",
        "time to run for, 0 for infinite, ex. 1h5m10s",
        kind="duration",
    )
    fs.add(
        "filterid",
        "",
        "display only messages matching an id in a comma-separated list of ids.",
        kind="uintset",
    )
    fs.add(
        "filtertype",
        "",
        "display only messages matching a type in a comma-separated list of types.",
        kind="uintset",
    )
    fs.add(
        "format",
        "plain",
        "decoded message output format: plain, csv, json, or xml",
    )
    fs.add(
        "unique",
        False,
        "suppress duplicate messages from each meter",
        kind="bool",
    )
    fs.add(
        "single",
        False,
        "one shot execution, if used with -filterid, will wait for exactly "
        "one packet from each meter id",
        kind="bool",
    )
    fs.add("version", False, "display build date and commit hash", kind="bool")
    # Extensions beyond the Go flag set
    fs.add(
        "fromfile",
        "",
        "decode a raw u8 IQ capture file instead of connecting to rtl_tcp "
        "('-' reads stdin)",
    )
    fs.add(
        "windowblocks",
        64,
        "sample blocks decoded per device program invocation",
        kind="int",
    )
    fs.add(
        "maxhits",
        256,
        "device-side preamble-hit capacity per window (overflow falls back "
        "to an exact host path)",
        kind="int",
    )
    fs.add(
        "mesh",
        False,
        "shard the decode across all visible devices (time axis; with "
        "-channels > 1, a 2-D channel x time mesh)",
        kind="bool",
    )
    fs.add(
        "channels",
        1,
        "wideband channelizer bank size: treat the input as one wideband "
        "stream at channels*samplerate and decode every channel (1 = the "
        "reference's single-channel receiver)",
        kind="int",
    )
    fs.add(
        "crosschanneldedup",
        False,
        "drop adjacent-channel ghost copies of a message (wideband mode): "
        "same digest seen on another channel in the same or adjacent block",
        kind="bool",
    )
    fs.add(
        "backend",
        "jnp",
        "accepted for flag parity with rtlamr_tpu; no effect here (the "
        "stencil always runs as the CUDA kernel on the card)",
    )
    fs.add(
        "coordinator",
        "",
        "multi-host decode: coordinator address "
        "(host:port). Launch the SAME command on every host with "
        "-numprocs/-procid; each process decodes its share of the "
        "-fromfile capture on the global device mesh",
    )
    fs.add(
        "numprocs",
        1,
        "multi-host decode: total number of processes",
        kind="int",
    )
    fs.add(
        "procid",
        0,
        "multi-host decode: this process's id (0-based)",
        kind="int",
    )
    fs.add(
        "cpudevices",
        0,
        "multi-host decode: simulate this many CPU devices per process "
        "(0 = use the real local accelerators)",
        kind="int",
    )
    fs.add(
        "latency",
        False,
        "low-latency live preset: small decode window (unless -windowblocks "
        "is set explicitly), block-granular reads, and synchronous window "
        "completion; trades batch throughput for sub-50ms feed->emit "
        "latency (see BENCH.md 'Live latency')",
        kind="bool",
    )
    fs.add(
        "profiledir",
        "",
        "write a torch profiler trace of the decode loop to this directory",
    )
    fs.add(
        "checkpoint",
        "",
        "stream checkpoint path: resume from it if present, save on exit",
    )
    fs.add(
        "metrics",
        False,
        "trace the decode loop; on exit print the counters, each span's "
        "time and the windows' turnaround to stderr",
        kind="bool",
    )
    fs.add(
        "ingest",
        "auto",
        "sample transport: native (C++ reader thread + ring buffer / mmap), "
        "python, or auto (native when buildable)",
    )
    # rtl_tcp flags (contributed by the rtltcp package in the reference,
    # main.go:320)
    fs.add("server", "127.0.0.1:1234", "address or hostname of rtl_tcp instance", rtlamr=False)
    fs.add("centerfreq", 0, "center frequency to receive on", kind="int", rtlamr=False)
    fs.add("samplerate", 0, "sample rate", kind="int", rtlamr=False)
    fs.add("tunergainmode", False, "enable/disable tuner gain", kind="bool", rtlamr=False)
    fs.add("tunergain", 0, "set tuner gain in dB", kind="int", rtlamr=False)
    fs.add("gainbyindex", -1, "set gain by index", kind="int", rtlamr=False)
    fs.add("agcmode", False, "enable/disable rtl agc", kind="bool", rtlamr=False)
    fs.add("freqcorrection", 0, "frequency correction in ppm", kind="int", rtlamr=False)
    fs.add("directsampling", False, "enable/disable direct sampling", kind="bool", rtlamr=False)
    fs.add("offsettuning", False, "enable/disable offset tuning", kind="bool", rtlamr=False)
    fs.add("biastee", False, "enable/disable bias tee", kind="bool", rtlamr=False)
    return fs
