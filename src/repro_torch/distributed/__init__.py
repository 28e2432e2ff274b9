"""Fault tolerance of the port's trainer (``fault.Watchdog``, an own copy
of the JAX package's ``distributed/fault.py``) and GPipe pipeline
parallelism over ``torch.distributed`` (``pipeline``)."""
