"""ML <-> ab-initio process separation over TCP (port of
``autoforce_tpu/calculator/socket.py``).

Counterpart of the reference's SocketCalculator / calc_server pair
(theforce/calculator/socketcalc.py, calc_server.py, util/server.py) with
the same wire protocol: requests are ``in_path:out_path[:script]``
strings, structures travel as extxyz files, the server answers the return
code as text (``?`` is answered ``!``, ``end`` stops the server).  The
oracle process (DFT, or any script) stays apart from the ML process on the
card.

Start a server with ``python -m autoforce_tpu_torch.calculator.calc_server
[-ip localhost] [-port 6666] [-calc script.py] [--device cuda]``;
``--device`` is where a script's ``make_calc(device)`` builds its oracle.
Both files of a request are written with exact floats
(``write_xyz(..., exact=True)``), so the client receives the oracle's
energy, forces and stress without rounding.

:func:`get_scope` loads an oracle script in this process, as the command
line does for ``inprocess = True``.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import socket
import time
import traceback

import numpy as np

from ..io.xyz import read_xyz, write_xyz
from ..system import SinglePointCalculator


class SocketCalculator:
    """TCP client; ships structures to a calc server.  ``calls`` counts the
    requests the server answered with success."""

    def __init__(self, ip="localhost", port=6666, script=None, wlog=False):
        self.ip = ip
        self.port = port
        self.script = script
        self.wlog = wlog
        self.calls = 0
        self.log("created", "w")

    def log(self, msg, mode="a"):
        if self.wlog:
            with open("socalc.log", mode) as f:
                f.write(f"{time.ctime()}   {msg}\n")

    def _send(self, msg):
        """Send one request; the server's answer, as text."""
        with socket.create_connection((self.ip, self.port)) as s:
            s.sendall(msg)
            return s.recv(1024).decode("utf-8")

    def ping(self):
        return self._send(b"?")

    @property
    def message(self):
        cwd = os.getcwd()
        msg = f"{cwd}/socket_send.xyz:{cwd}/socket_recv.xyz"
        if self.script is not None:
            msg = f"{msg}:{os.path.abspath(self.script)}"
        return msg

    def calculate(self, system):
        self.log("s")
        write_xyz("socket_send.xyz", system, forces=False, exact=True)
        ierr = int(self._send(self.message.encode()))
        if ierr != 0:
            raise RuntimeError(
                "SocketCalculator failed! Check the ab initio server."
            )
        self.calls += 1
        self.log("e")
        out = read_xyz("socket_recv.xyz", index=0)
        res = dict(out.calc.results)
        for name in ("socket_send.xyz", "socket_recv.xyz"):
            os.remove(name)
        if "stress" not in res:
            res["stress"] = np.zeros(6)
        return res

    def close(self):
        with socket.create_connection((self.ip, self.port)) as s:
            s.sendall(b"end")


class Server:
    """Minimal TCP request loop (util/server.py:7-43).  ``port=0`` binds a
    port that the OS chooses; ``self.port`` is the bound one."""

    def __init__(self, ip, port, callback=None, args=(), wlog=False):
        self.socket = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.socket.bind((ip, port))
        self.port = self.socket.getsockname()[1]
        self.callback = callback if callback else (lambda a: 0)
        self.args = args
        self.wlog = wlog

    def listen(self, end="end", ping="?"):
        self.socket.listen(5)
        resume = True
        while resume:
            c, addr = self.socket.accept()
            try:
                request = c.recv(1024).decode("utf-8").strip()
                if request == end:
                    resume = False
                elif request == ping:
                    c.send(b"!")
                else:
                    try:
                        self.callback(request, *self.args)
                        c.send(b"0")
                    except Exception:
                        # rc -1 to the client (reference util/server.py
                        # error path); keep the cause visible server-side
                        traceback.print_exc()
                        c.send(b"-1")
            except OSError:
                # a client that vanished must not take the server down
                # (reference server keeps serving across bad requests)
                pass
            finally:
                c.close()
        self.socket.close()


_imported = {}


def _dotted_name(script):
    """Dotted module name when ``script`` lives inside this package (the
    file-location loader cannot resolve those modules' imports); None for
    arbitrary user scripts."""
    import autoforce_tpu_torch

    pkg_dir = os.path.dirname(os.path.abspath(autoforce_tpu_torch.__file__))
    path = os.path.abspath(script)
    if not path.startswith(pkg_dir + os.sep) or not path.endswith(".py"):
        return None
    rel = os.path.relpath(path, os.path.dirname(pkg_dir))
    return rel[: -len(".py")].replace(os.sep, ".")


def get_scope(script, device="cuda"):
    """Load {'calc', 'preprocess_atoms'?, 'postprocess_atoms'?} from a
    python script (module-import cache, calc_server.py:37-53).  A script
    that defines ``make_calc(device)`` (the package's oracle scripts and
    adapters) gets its oracle built on ``device``; any other must define
    ``calc``."""
    if script not in _imported:
        name = _dotted_name(script)
        if name is not None:
            mod = importlib.import_module(name)
        else:
            spec = importlib.util.spec_from_file_location(
                "_oracle_import", script
            )
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        _imported[script] = mod
    mod = _imported[script]
    make = getattr(mod, "make_calc", None)
    scope = {"calc": make(device) if make is not None else mod.calc}
    for hook in ("preprocess_atoms", "postprocess_atoms"):
        if hasattr(mod, hook):
            scope[hook] = getattr(mod, hook)
    return scope


def serve_request(request, calc=None, device="cuda"):
    """Handle one 'in:out[:script[:ref]]' request (calc_server.py:56-86);
    a script named in the request builds its oracle on ``device``."""
    scope = {}
    if ":" in request:
        parts = request.split(":")
        if len(parts) == 2:
            i, o = parts
        elif len(parts) >= 3:
            i, o, c = parts[:3]
            scope = get_scope(c, device=device)
            calc = scope["calc"]
        else:
            raise RuntimeError(f"bad request {request}")
    else:
        i = o = request
    with open(o, "w") as f:
        f.write(f"{time.ctime()} reserved\n")
    system = read_xyz(i, index=0)
    system.calc = calc
    if "preprocess_atoms" in scope:
        scope["preprocess_atoms"](system)
    res = {
        "energy": system.get_potential_energy(),
        "forces": system.get_forces(),
    }
    try:
        res["stress"] = system.get_stress()
    except Exception:
        pass
    if "postprocess_atoms" in scope:
        scope["postprocess_atoms"](system)
    system.calc = SinglePointCalculator(system, **res)
    write_xyz(o, system, exact=True)


def main():
    import argparse

    parser = argparse.ArgumentParser(description="Starts a calculation server.")
    parser.add_argument("-ip", "--ip", default="localhost")
    parser.add_argument("-port", "--port", type=int, default=6666)
    parser.add_argument("-calc", "--calculator", default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the oracle scripts (make_calc)")
    args = parser.parse_args()
    calc = (get_scope(args.calculator, device=args.device)["calc"]
            if args.calculator else None)
    server = Server(args.ip, args.port, callback=serve_request,
                    args=(calc, args.device))
    print(f"calc_server listening on {args.ip}:{server.port}", flush=True)
    server.listen()


if __name__ == "__main__":
    main()
