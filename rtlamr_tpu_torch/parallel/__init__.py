from .mesh import MeshDecoder
from .wideband import CrossChannelDeduper, WidebandDecoder

__all__ = ["CrossChannelDeduper", "MeshDecoder", "WidebandDecoder"]
