"""The benchmark's plain reference: a frozen copy of the receiver's NumPy
oracle (``decoder.py``, ``dedup.py``), its four ``-msgtype=all`` protocol
parsers and their bit, CRC and GF(32) helpers, plus the exact decode stencil
in plain NumPy (``stencil.py``) and the packet builders the traffic
generator uses (``packets.py``).

Nothing here imports ``rtlamr_tpu_torch``, ``rtlamr_tpu``, ``jax`` or
``torch``: the reference works from the bytes the benchmark generated, never
from what the program made. Later changes to the program leave these files
as they are.
"""
