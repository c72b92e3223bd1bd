"""rtlamr_tpu_torch — the ERT smart-meter receiver on PyTorch and CUDA.

The PyTorch/H100 port of ``rtlamr_tpu``: the same decoder, flag surface and
output formats, with the device compute in plain PyTorch plus hand-written
CUDA kernels for Hopper (``sm_90a``). It keeps its own copies of the host
layer and imports nothing of the JAX package.

- ``protocols/``, ``utils/``, ``io/``, ``ref/synth.py``,
  ``cli/{flags,encoders,filters}.py``, ``decoder/dedup.py``: numpy/stdlib
  host layer, copied from the JAX package.
- ``ops/spec.py``      the window/stage geometry (value-equal to the JAX spec,
  so one staged u16 buffer feeds both packages).
- ``ops/stencil.py``   the fused decode stencil: the CUDA kernel
  ``csrc/decode_stencil.cu`` for CUDA tensors, its plain PyTorch version for
  CPU tensors.
- ``ops/search.py``    hit compaction, plateau collapse, packet slicing and
  the CRC-16 / Reed-Solomon gates in PyTorch ops.
- ``ops/frontend.py``  the packed per-window result buffer and the K-window
  batch.
- ``ops/channelizer.py`` the polyphase filter bank, DFT mix and requantize in
  plain PyTorch; ``ops/channelizer_fused.py`` the fused channelizer: the
  CUDA kernel ``csrc/channelizer.cu`` for CUDA tensors, its plain version
  for CPU tensors.
- ``decoder/``         the streaming ``WindowDecoder`` and checkpoints.
- ``parallel/``        the wideband ``WidebandDecoder`` (channelize, then one
  window program per channel) and the time-sharded ``MeshDecoder`` (one
  process over a list of devices).
- ``native/``          the C++ sample transport (rtl_tcp reader thread and
  ring, mmapped files, ``read_staged``), built with g++ on first use.
- ``cli/``             ``python -m rtlamr_tpu_torch``, narrowband and
  ``-channels N`` wideband on one card, ``-mesh`` over every local card.

Entry points run on the card (``device=None`` means ``cuda``) and raise when
there is none; pass ``device="cpu"`` to run the plain versions on the CPU.
"""

__version__ = "0.1.0"
