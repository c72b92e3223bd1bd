"""Chip-length / sample-rate calculator (reference: misc/modes.go).

A chip length is usable for live rtl-sdr receive when 32768 * chip_length
falls in librtlsdr's supported sample-rate bands (225-300 kHz and
900 kHz - 3.2 MHz, misc/modes.go:14-31). The -symbollength flag whitelist
(flags.go:127-132) is the multiples-of-8 subset of these. Also computes the
ERT channel coverage for a given rate (channel width 196,568 Hz,
misc/modes.go:16).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

DATA_RATE = 32768  # bits/s (scm/scm.go:45)
CHANNEL_WIDTH = 196_568  # Hz (misc/modes.go:16)
ISM_BAND_HZ = (902_000_000, 928_000_000)

# librtlsdr sample-rate bands (misc/modes.go:20-23); min exclusive, max
# inclusive per the comparison at misc/modes.go:29.
LOWER_MIN, LOWER_MAX = 225_000, 300_000
UPPER_MIN, UPPER_MAX = 900_000, 3_200_000


@dataclass(frozen=True)
class Mode:
    chip_length: int
    sample_rate: int
    channels: int
    excess_bandwidth: int


def is_valid_live_chip_length(chip_length: int) -> bool:
    rate = chip_length * DATA_RATE
    return (LOWER_MIN < rate <= LOWER_MAX) or (UPPER_MIN < rate <= UPPER_MAX)


def sample_rate_for(chip_length: int) -> int:
    return DATA_RATE * chip_length


def valid_chip_lengths(max_chip_length: int | None = None) -> List[Mode]:
    """All chip lengths a dongle supports (misc/modes.go:26-33)."""
    if max_chip_length is None:
        max_chip_length = math.ceil(UPPER_MAX / DATA_RATE) - 1
    out = []
    for cl in range(1, max_chip_length + 1):
        if is_valid_live_chip_length(cl):
            rate = sample_rate_for(cl)
            out.append(
                Mode(cl, rate, rate // CHANNEL_WIDTH, rate % CHANNEL_WIDTH)
            )
    return out


def main() -> None:
    for m in valid_chip_lengths():
        print(
            f"SymbolLength:{m.chip_length} SampleRate:{m.sample_rate} "
            f"Channels:{m.channels} ExcessBandwidth:{m.excess_bandwidth}"
        )


if __name__ == "__main__":
    main()
