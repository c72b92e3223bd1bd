from .decoder import ReferenceDecoder, mag_int, mag_lut_f32
from . import synth

__all__ = ["ReferenceDecoder", "mag_int", "mag_lut_f32", "synth"]
