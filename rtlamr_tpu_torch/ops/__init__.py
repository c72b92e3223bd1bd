from .channelizer import ChannelizerSpec, channelize
from .channelizer_fused import channelize_requantize_fused, channelize_requantize_plain
from .spec import FrontendSpec, GroupSpec, make_frontend_spec, stage_host, staged_geometry

__all__ = [
    "ChannelizerSpec",
    "FrontendSpec",
    "GroupSpec",
    "channelize",
    "channelize_requantize_fused",
    "channelize_requantize_plain",
    "make_frontend_spec",
    "stage_host",
    "staged_geometry",
]
