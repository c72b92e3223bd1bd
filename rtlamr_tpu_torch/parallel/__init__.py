from .wideband import CrossChannelDeduper, WidebandDecoder

__all__ = ["CrossChannelDeduper", "WidebandDecoder"]
