"""The root conftest.py's xdist scheduler, run on a throwaway project.

Under ``--dist loadfile`` the files in ``SPLIT_FIRST`` must be split into
one work unit per item, dispatched first, to different workers, with the
smallest units queued behind them, while every other file still runs
whole on one worker, at a lower CPU priority.  Other dist modes, and runs
without xdist, must not see the hooks.
"""

import importlib.util
import os
import re
import shutil
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

RECORD = """\
import os
from pathlib import Path


def record(name):
    with open(Path(__file__).parent.parent / "order.log", "a") as f:
        worker = os.environ.get('PYTEST_XDIST_WORKER', 'main')
        f.write(f"{worker} {name} {os.nice(0)}\\n")
"""

# Plain loadfile would queue test_sharding.py last (fewest items) and run
# both of its items on one worker.
FILES = {"test_sharding.py": 2, "test_alpha.py": 6, "test_beta.py": 5,
         "test_gamma.py": 4, "test_delta.py": 3}


def _project(tmp_path):
    shutil.copy(ROOT / "conftest.py", tmp_path / "conftest.py")
    (tmp_path / "pytest.ini").write_text("[pytest]\n")
    tests = tmp_path / "tests"
    tests.mkdir()
    for name, n in FILES.items():
        body = [RECORD]
        for i in range(n):
            body.append(f"\ndef test_{i}():\n"
                        f"    record('tests/{name}::test_{i}')\n")
        (tests / name).write_text("".join(body))
    return tmp_path


def _run(project, *args):
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    env["PYTEST_DISABLE_PLUGIN_AUTOLOAD"] = "1"
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "tests", "-p", "no:cacheprovider",
         *args],
        cwd=project, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    passed = re.search(r"(\d+) passed", r.stdout)
    assert passed, r.stdout
    runs = defaultdict(list)  # worker -> nodeids in the order it ran them
    nice = {}  # nodeid -> the niceness it ran at
    for line in (project / "order.log").read_text().splitlines():
        worker, nodeid, niceness = line.split()
        runs[worker].append(nodeid)
        nice[nodeid] = int(niceness)
    return int(passed.group(1)), runs, nice


def _root_conftest():
    spec = importlib.util.spec_from_file_location("root_conftest",
                                                  ROOT / "conftest.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_loadfile_dispatches_listed_file_first_one_item_per_worker(tmp_path):
    n, runs, nice = _run(_project(tmp_path), "-p", "xdist", "-n", "3",
                         "--dist", "loadfile")
    assert n == sum(FILES.values())
    heavy = ["tests/test_sharding.py::test_0", "tests/test_sharding.py::test_1"]
    # Each heavy item is the first test of its worker, so they ran on two.
    firsts = sorted(ids[0] for ids in runs.values())
    assert [nodeid for nodeid in firsts if nodeid in heavy] == heavy, dict(runs)
    # Behind them wait the two smallest files, not the largest left.
    behind = sorted(ids[1].split("::")[0] for ids in runs.values()
                    if ids[0] in heavy)
    assert behind == ["tests/test_delta.py", "tests/test_gamma.py"], dict(runs)
    for name in FILES:
        if name != "test_sharding.py":
            workers = {w for w, ids in runs.items() for nodeid in ids
                       if nodeid.startswith(f"tests/{name}::")}
            assert len(workers) == 1, (name, dict(runs))
    # The heavy items keep the workers' first priority; the rest run lower.
    start = nice[heavy[0]]
    assert nice[heavy[1]] == start
    assert {nice[nodeid] for nodeid in nice if nodeid not in heavy} \
        == {min(start + 10, 19)}


@pytest.mark.parametrize("args", [
    ("-p", "xdist", "-n", "2", "--dist", "load"),
    ("-p", "no:xdist"),
], ids=["dist_load", "no_xdist"])
def test_hook_stays_out_of_other_modes(tmp_path, args):
    n, runs, nice = _run(_project(tmp_path), *args)
    assert n == sum(FILES.values())
    assert sum(len(ids) for ids in runs.values()) == n
    assert len(set(nice.values())) == 1


@pytest.mark.parametrize(
    "dist", ["no", "load", "loadscope", "loadgroup", "worksteal", "each"])
def test_hook_returns_none_unless_loadfile(dist):
    class Config:
        def getvalue(self, name):
            assert name == "dist"
            return dist

    assert _root_conftest().pytest_xdist_make_scheduler(Config(), None) is None


def test_root_conftest_imports_nothing_heavy():
    code = ("import runpy, sys; runpy.run_path(sys.argv[1]); "
            "print(sorted({'jax', 'torch', 'xdist'} & set(sys.modules)))")
    r = subprocess.run([sys.executable, "-c", code, str(ROOT / "conftest.py")],
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
