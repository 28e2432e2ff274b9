"""Fault tolerance of the port's trainer: ``fault.Watchdog``, an own copy
of the JAX package's ``distributed/fault.py``.  Pipeline parallelism
(``distributed/pipeline.py``) waits for ROADMAP Queue 1 item 9."""
