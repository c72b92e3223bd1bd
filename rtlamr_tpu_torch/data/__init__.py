"""Meter compatibility data (reference: meters.csv, meters.md).

The FCC-sourced table of ERT-compatible meters: manufacturer, model,
commodity type, ERT message types and frequency band, plus the
commodity -> ERT-type mapping documented in meters.md (electric
04,05,07,08,12; gas 00,01,02,09,12; water 03,11,13).
"""

from __future__ import annotations

import csv
import functools
import pathlib
from dataclasses import dataclass
from typing import List

_DATA_DIR = pathlib.Path(__file__).parent

# meters.md commodity -> ERT type table
COMMODITY_ERT_TYPES = {
    "electric": (4, 5, 7, 8, 12),
    "gas": (0, 1, 2, 9, 12),
    "water": (3, 11, 13),
}


@dataclass(frozen=True)
class Meter:
    url: str
    manufacturer: str
    model: str
    commodity: str
    ert_type: str
    lower_mhz: str
    upper_mhz: str


@functools.lru_cache(maxsize=1)
def load_meters() -> List[Meter]:
    """Parse the bundled meters.csv compatibility table.

    Columns (meters.csv:1): URL, Manufacturer, Model Name, Commodity,
    ERT Type, Lower (MHz), Upper (MHz).
    """
    out: List[Meter] = []
    with open(_DATA_DIR / "meters.csv", newline="") as f:
        reader = csv.reader(f)
        next(reader)  # header
        for row in reader:
            if len(row) < 7:
                row = row + [""] * (7 - len(row))
            out.append(Meter(*[c.strip() for c in row[:7]]))
    return out


def commodity_for_ert_type(ert_type: int) -> List[str]:
    """Commodities a numeric ERT type can carry (meters.md mapping)."""
    return [
        name
        for name, types in COMMODITY_ERT_TYPES.items()
        if ert_type in types
    ]
