"""Drivers: how a cell runs the port.  A workload file names its driver
(``"driver": "device_md"``), and the harness imports
``portbench.drivers.<driver>``, whose ``Cell`` class it drives."""
