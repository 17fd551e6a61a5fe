"""What the benchmark loads, and the characters of BENCHMARK.json."""

import json
import os
import re
import subprocess
import sys

import pytest

from portbench import harness

ROOT = harness.ROOT


def _modules_after(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    """The command refuses without a card; then a tiny cell's whole run on
    the CPU: no top-level module jax, jaxlib, flax or autoforce_tpu (whole
    names: autoforce_tpu_torch passes)."""
    code = (
        "import json, sys, torch\n"
        "from portbench import run, harness\n"
        "torch.cuda.is_available = lambda: False\n"
        "rc = run.main(['--workload', 'md.lgps4_m1024.100k', '--seed', '1',"
        " '--seconds', '1', '--trace', '0'])\n"
        "assert rc != 0\n"
        "d = 'portbench/tests/data'\n"
        "harness.run_cell('md.cu_tiny', 1, 0.1, False, device='cpu',"
        " workload_dirs=(d,), config_dirs=(d,))\n"
        "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))\n")
    top = _modules_after(code)
    assert not top & set(harness.FORBIDDEN)
    assert "autoforce_tpu_torch" in top


def test_reference_loads_nothing_of_the_port():
    code = (
        "import json, sys\n"
        "import portbench.reference.judge, portbench.reference.model\n"
        "import portbench.control\n"
        "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))\n")
    top = _modules_after(code)
    assert "autoforce_tpu_torch" not in top
    assert not top & set(harness.FORBIDDEN)


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_and_units(bench):
    names = []
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["config"])
        assert NAME.match(w["traffic"]) and _line(w["why"])
        names.append(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in bench["per_layer"]:
        assert _line(m["layer"])
    assert len(names) == len(set(names))
    assert all(_line(w) for w in bench["command"])


def test_manifest_matches_its_files(bench):
    """Each listed cell, configuration and per-layer metric has its file,
    and they agree with the manifest."""
    readers = harness.readers()
    configs = {c["name"]: c for c in bench["configs"]}
    for c in configs.values():
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert harness.load(c["name"], (harness.CONFIGS,))["name"] == c["name"]
    for w in bench["workloads"]:
        work = harness.load(w["name"], (harness.WORKLOADS,))
        assert work["config"] == w["config"] in configs
        assert work["traffic"] == w["traffic"]
        assert int(work["chips"]) == w["chips"] == 1
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["per_layer"]:
        assert m["name"] in readers and readers[m["name"]].UNIT == m["unit"]
        assert m["moves"] in e2e
