"""The port's copies of the JAX package's JAX-free host modules against the
originals on the same inputs: the chip-length calculator
(``utils/modes.py``), the meter table (``data/``, read from the port's own
``meters.csv``) and the NumPy oracle ``ReferenceDecoder`` in both
arithmetics."""

import pathlib

import numpy as np
import pytest

from rtlamr_tpu import data as jax_data
from rtlamr_tpu.protocols import new_parser as jax_parser
from rtlamr_tpu.ref import ReferenceDecoder as JaxReference
from rtlamr_tpu.ref import synth as jax_synth
from rtlamr_tpu.utils import modes as jax_modes
from rtlamr_tpu_torch import data
from rtlamr_tpu_torch.protocols import new_parser
from rtlamr_tpu_torch.ref import ReferenceDecoder
from rtlamr_tpu_torch.utils import modes

SAMPLE = pathlib.Path(__file__).parent / "fixtures" / "sample.bin"


def test_modes_match_the_jax_package():
    # misc/modes.go:26-33: valid chip lengths are 7-9 and 28-97; the
    # -symbollength flag whitelist is the multiples-of-8 subset.
    got = modes.valid_chip_lengths()
    assert {m.chip_length for m in got} == set(range(7, 10)) | set(range(28, 98))
    assert [tuple(vars(m).values()) for m in got] == [
        tuple(vars(m).values()) for m in jax_modes.valid_chip_lengths()]
    for cl in range(1, 120):
        assert modes.is_valid_live_chip_length(cl) == jax_modes.is_valid_live_chip_length(cl)
        assert modes.sample_rate_for(cl) == jax_modes.sample_rate_for(cl)
    assert modes.sample_rate_for(72) == 2359296
    assert [m for m in got if m.chip_length == 72][0].channels == 12


def test_modes_main_prints_the_table(capsys):
    modes.main()
    out = capsys.readouterr().out
    jax_modes.main()
    assert out == capsys.readouterr().out
    assert "SymbolLength:72 SampleRate:2359296 Channels:12" in out


def test_meters_data_matches_the_jax_package():
    meters = data.load_meters()
    assert len(meters) >= 60  # meters.csv ships 67 rows
    assert [tuple(vars(m).values()) for m in meters] == [
        tuple(vars(m).values()) for m in jax_data.load_meters()]
    assert any(m.manufacturer == "Itron" for m in meters)
    for ert in range(16):
        assert data.commodity_for_ert_type(ert) == jax_data.commodity_for_ert_type(ert)
    assert data.commodity_for_ert_type(4) == ["electric"]
    assert set(data.commodity_for_ert_type(12)) == {"electric", "gas"}
    assert data.COMMODITY_ERT_TYPES == jax_data.COMMODITY_ERT_TYPES
    # The port reads its own copy of the table, not the JAX package's.
    assert data._DATA_DIR != jax_data._DATA_DIR
    assert (data._DATA_DIR / "meters.csv").read_bytes() == (
        jax_data._DATA_DIR / "meters.csv").read_bytes()


def all_protocols_capture(chip_length=72):
    """tests/test_ref_decoder.py's all-protocols capture: one SCM, SCM+, IDM
    and R900 burst a PacketLength + 1 block apart."""
    cfg = JaxReference([jax_parser(n, chip_length) for n in ("scm", "scm+", "idm", "r900")]).cfg
    gap = cfg.packet_length + cfg.block_size
    bursts = [
        jax_synth.bits_to_burst(jax_synth.make_scm_bits(meter_id=111111), offset=gap),
        jax_synth.bits_to_burst(jax_synth.make_scmplus_bits(endpoint_id=222222), offset=2 * gap),
        jax_synth.bits_to_burst(jax_synth.make_idm_bits(serial=333333), offset=3 * gap),
        jax_synth.r900_burst(jax_synth.make_r900_symbols(meter_id=1222333444), offset=4 * gap),
    ]
    last = max(b.offset + b.chips.size * chip_length for b in bursts)
    n_blocks = (last + cfg.packet_length) // cfg.block_size + 2
    return jax_synth.render_iq(n_blocks * cfg.block_size, bursts, chip_length, noise=0.0, seed=1)


@pytest.mark.parametrize("arithmetic", ["float32", "int"])
@pytest.mark.parametrize("capture", ["sample.bin", "all_protocols"])
def test_reference_decoder_matches_the_jax_package(capture, arithmetic):
    if capture == "sample.bin":
        names, chip_length = ("scm",), 78
        iq = np.fromfile(SAMPLE, np.uint8)
    else:
        names, chip_length = ("scm", "scm+", "idm", "r900"), 72
        iq = all_protocols_capture(chip_length)
    got = ReferenceDecoder([new_parser(n, chip_length) for n in names],
                           arithmetic=arithmetic).decode_capture(iq)
    want = JaxReference([jax_parser(n, chip_length) for n in names],
                        arithmetic=arithmetic).decode_capture(iq)
    assert [(b, str(m)) for b, m in got] == [(b, str(m)) for b, m in want]
    if capture == "sample.bin":
        assert len(got) == 14 and got[0][1].ID == 17580293
    else:
        assert sorted(m.msg_type() for _, m in got) == ["IDM", "R900", "SCM", "SCM+"]
