"""The benchmark of ``rtlamr_tpu_torch``, the PyTorch and CUDA receiver.

``python -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell once and prints one JSON result line; README.md says
how cells, mixes, configurations and per-layer metrics are added as files.
"""
