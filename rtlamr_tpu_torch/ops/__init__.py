from .channelizer import ChannelizerSpec, channelize
from .channelizer_fused import channelize_requantize_fused, channelize_requantize_plain
from .frontend import decode_window, run_window
from .spec import FrontendSpec, GroupSpec, make_frontend_spec, stage_host, staged_geometry

__all__ = [
    "ChannelizerSpec",
    "FrontendSpec",
    "GroupSpec",
    "channelize",
    "channelize_requantize_fused",
    "channelize_requantize_plain",
    "decode_window",
    "make_frontend_spec",
    "run_window",
    "stage_host",
    "staged_geometry",
]
