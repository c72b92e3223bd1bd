"""Traffic: the mixes' parameter files (``<name>.json``), the general
generator that plans and renders them (``plan.py``) and the load
generator's process (``feeder.py``)."""
