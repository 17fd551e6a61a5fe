"""Remote-run conveniences: ssh port forwarding, port clearing, twin-run.

Port of ``autoforce_tpu/remote.py``, the counterpart of the reference's
``theforce/util/ssh.py``, ``util/clear_port.py`` and
``util/twinrun.py``: small host-side helpers for the ML <-> DFT process
separation.  The typical deployment runs
:mod:`autoforce_tpu_torch.calculator.calc_server` on the cluster holding
the ab-initio license and the ML process on a GPU elsewhere; an ssh
tunnel bridges the socket.

CLI:

    python -m autoforce_tpu_torch.remote forward <port> <user@host> [--ip IP]
    python -m autoforce_tpu_torch.remote clear <port>
    python -m autoforce_tpu_torch.remote twin <script.py> [--ip IP] [--port P]
        [--calc NAME] [--device cuda]
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time


def forward_port(port, remote, ip="localhost", extra=()):
    """Open a background ssh tunnel ``ip:port`` -> ``remote`` (reference
    util/ssh.py forward_port).  Returns the ssh exit status."""
    cmd = ["ssh", "-N", "-f", "-L", f"{ip}:{port}:{ip}:{port}",
           *extra, str(remote)]
    return subprocess.call(cmd)


def port_pids(port):
    """PIDs listening on/connected to ``port`` (via lsof)."""
    try:
        out = subprocess.run(
            ["lsof", "-ti", f":{int(port)}"],
            capture_output=True, text=True, check=False,
        ).stdout
    except FileNotFoundError:
        return []
    return [int(p) for p in out.split()]


def clear_port(port, sig=signal.SIGKILL, wait=0.1):
    """Kill every process occupying ``port`` (reference util/clear_port);
    returns the list of (pid, ok) pairs."""
    out = []
    for pid in port_pids(port):
        try:
            os.kill(pid, sig)
            ok = True
        except OSError:
            ok = False
        time.sleep(wait)
        out.append((pid, ok))
    return out


def twinrun(pyscript, ip="localhost", port=6666, calculator=None, args=(),
            device="cuda"):
    """Start a calc_server and the driver script as twin processes
    (reference util/twinrun.py); shuts the server down when the script
    exits.  Returns the script's exit code.  ``device``: the torch device
    of the server's oracle scripts (``--device``; the server never falls
    back to another)."""
    server_cmd = [
        sys.executable, "-m", "autoforce_tpu_torch.calculator.calc_server",
        "-ip", str(ip), "-port", str(port), "--device", str(device),
    ]
    if calculator:
        if not os.path.isfile(str(calculator)):
            # predefined oracle names ('EMT', 'LJ', 'ZERO', ...) map to
            # the bundled scripts, same rule as the CLI layer
            from .cl import _calc_script

            calculator = _calc_script(str(calculator))
        server_cmd += ["-calc", str(calculator)]
    # subprocesses must find the package regardless of cwd; the package's
    # parent goes first on PYTHONPATH, the caller's entries are kept
    env = dict(os.environ)
    pkg_parent = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [pkg_parent] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
    )
    server = subprocess.Popen(server_cmd, env=env)
    try:
        # wait for the server socket (importing the backend takes seconds)
        import socket as socketlib

        deadline = time.time() + 120
        while time.time() < deadline:
            if server.poll() is not None:
                raise RuntimeError("calc_server exited during startup")
            try:
                probe = socketlib.create_connection((ip, int(port)),
                                                    timeout=1.0)
                probe.send(b"?")  # server ping keeps the loop alive
                probe.recv(8)  # read the reply BEFORE closing (no RST)
                probe.close()
                break
            except OSError:
                time.sleep(0.5)
        rc = subprocess.call([sys.executable, pyscript, *args], env=env)
    finally:
        # polite shutdown: the server's listen loop exits on b"end"
        import socket as socketlib

        try:
            s = socketlib.socket()
            s.settimeout(2.0)
            s.connect((ip, int(port)))
            s.send(b"end")
            s.close()
        except OSError:
            pass
        try:
            server.wait(timeout=5)
        except subprocess.TimeoutExpired:
            server.terminate()
    return rc


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)
    f = sub.add_parser("forward")
    f.add_argument("port", type=int)
    f.add_argument("remote")
    f.add_argument("--ip", default="localhost")
    c = sub.add_parser("clear")
    c.add_argument("port", type=int)
    t = sub.add_parser("twin")
    t.add_argument("pyscript")
    t.add_argument("--ip", default="localhost")
    t.add_argument("--port", type=int, default=6666)
    t.add_argument("--calc", default=None)
    t.add_argument("--device", default="cuda")
    ns, unknown = parser.parse_known_args(argv)
    if ns.cmd == "forward":
        return forward_port(ns.port, ns.remote, ip=ns.ip)
    if ns.cmd == "clear":
        print(f"killed: {clear_port(ns.port)}")
        return 0
    if ns.cmd == "twin":
        return twinrun(ns.pyscript, ip=ns.ip, port=ns.port,
                       calculator=ns.calc, args=unknown, device=ns.device)


if __name__ == "__main__":
    sys.exit(main())
