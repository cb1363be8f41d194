"""The resilience ladder: seeded fault injection and its configs
(``faults.py``), the watchdog's demotion controller (``degrade.py``) and
the bounded admission queue (``recovery.py``)."""
