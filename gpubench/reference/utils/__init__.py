"""Bit packing, CRC-16 and GF(32) helpers of the protocol parsers."""
