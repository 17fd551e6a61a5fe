"""Oracle scripts for the command line (``calculator='EMT'`` etc. in an
ARGS file).  Each defines ``make_calc(device)``; ``socket.get_scope``
builds the oracle on the device the ARGS name."""
