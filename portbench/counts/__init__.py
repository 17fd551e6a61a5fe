"""Operation and byte counts the benchmark's rooflines and mfu divide by.

Frozen copies: a later edit to the port's own counters cannot move the
yardstick (``portbench/tests/test_portbench_counts.py`` pins them)."""
