"""Calculation-server entry point (port of
``autoforce_tpu/calculator/calc_server.py``; name parity with the
reference): ``python -m autoforce_tpu_torch.calculator.calc_server -calc
script.py [-port 6666] [--device cuda]``.  Implementation lives in
calculator/socket.py."""

from .socket import Server, get_scope, main, serve_request  # noqa: F401

if __name__ == "__main__":
    main()
