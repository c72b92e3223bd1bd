from .mesh import MeshDecoder
from .wideband import CrossChannelDeduper, WidebandDecoder
from .wideband_mesh import WidebandMeshDecoder

__all__ = ["CrossChannelDeduper", "MeshDecoder", "WidebandDecoder", "WidebandMeshDecoder"]
