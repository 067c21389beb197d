"""Limits on the time and the CPU work of every test.

Each test, its fixtures' set-up and teardown included, runs under a timer of
``LIMIT_S`` seconds. When the timer fires, faulthandler writes every thread's
stack to stderr. Inside a pytest-xdist worker it then ends the worker as well:
a Python signal cannot interrupt an XLA compile or a blocked wait, but
faulthandler's watchdog is a native thread. A serial run only gets the stacks,
as with pytest's own ``faulthandler_timeout`` (which must stay unset: a process
has one such timer).

xdist reports the test that was running when a worker died as failed, then
puts it back in the queue with the rest of its file, and so would run a hang
again on every worker it reaches until its cap on restarts. So each worker
claims a test in a directory shared by the run before it runs it, and passes
over a test that another worker has claimed already: a crash is reported once
and the rest of its file goes on.

Each xdist worker gets its share of the cores for its thread pools, and a run
that has imported JAX compiles each program once per process (see
``pytest_configure``): without these the tier-1 command did not end within its
limit.

``--dist loadfile`` hands out the files with the most tests first, so a file of
a few slow tests starts last and ends after every other worker is idle. Here
the files go out slowest first, by their seconds in a measured run of the suite
(``file_seconds.json``; ``python tests/_suite_limits.py JUNIT_XML`` writes it
anew from the tier-1 command's junit report).

``tests/conftest.py`` loads this module; ``-p _suite_limits`` loads it into a
run without that conftest.
"""

import faulthandler
import collections
import hashlib
import json
import os
import shutil
import sys
import tempfile
import time
import xml.etree.ElementTree

import pytest

LIMIT_S = 600.0
FILE_SECONDS = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "file_seconds.json"
)

_CLAIMS = "suite_limits_claims"  # the key of the shared directory in workerinput
_STDERR = pytest.StashKey[int]()
_DEADLINE = pytest.StashKey[float]()
_CLAIMS_DIR = pytest.StashKey[str]()
_JAX_CACHE = pytest.StashKey[str]()


def pytest_configure(config):
    # Left to itself, each xdist worker's OpenMP, MKL and OpenBLAS pools take
    # every core, and their threads spin waiting on one another. So each
    # worker gets its share; a setting already in the environment wins.
    # (numpy's OpenBLAS, loaded before this runs, keeps its pool; scipy's and
    # torch's are loaded later, by the test modules, and take the share.)
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if workers:
        share = str(max(1, len(os.sched_getaffinity(0)) // workers))
        for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
            os.environ.setdefault(var, share)
    # The distributed layer runs shard_map eagerly, and JAX compiles the same
    # small programs again on each call: one case of test_parallel.py's
    # test_distributed_vs_oracle_2x2x2 compiles 578 times, its four cases some
    # 200 distinct programs. JAX's persistent cache, keyed by the program,
    # serves the repeats. It is this process's own, in a new temporary
    # directory, so no two workers write one file and no run reads another's.
    jax = sys.modules.get("jax")  # tests/conftest.py has imported it
    if jax is not None:
        config.stash[_JAX_CACHE] = tempfile.mkdtemp(prefix="jax_cache_")
        jax.config.update("jax_compilation_cache_dir", config.stash[_JAX_CACHE])
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    # The test's own stderr is captured into a file that a killed worker
    # never shows, so the stacks go to a copy of the session's stderr.
    config.stash[_STDERR] = os.dup(2)
    if hasattr(config.option, "loadscopereorder"):
        config.option.loadscopereorder = False  # keep the order set below
    claims = getattr(config, "workerinput", {}).get(_CLAIMS)
    if claims is not None:
        config.pluginmanager.register(_RunOnce(claims), "suite_limits_run_once")


def pytest_collection_modifyitems(items):
    # Each xdist worker collects, and their orders must agree: a stable sort
    # keeps collection order within a file and among files not measured yet.
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return
    with open(FILE_SECONDS) as f:
        seconds = json.load(f)
    items.sort(key=lambda item: -seconds.get(item.path.name, 0.0))


def pytest_unconfigure(config):
    os.close(config.stash[_STDERR])
    for key in (_CLAIMS_DIR, _JAX_CACHE):
        if key in config.stash:
            shutil.rmtree(config.stash[key], ignore_errors=True)


@pytest.hookimpl(optionalhook=True)
def pytest_configure_node(node):
    # On the xdist controller, for each worker it starts, replacements too.
    # Under ``--dist each`` every worker runs every test: nothing to share.
    config = node.config
    if config.getoption("dist", None) == "each":
        return
    if _CLAIMS_DIR not in config.stash:
        config.stash[_CLAIMS_DIR] = tempfile.mkdtemp(prefix="pytest_claims_")
    node.workerinput[_CLAIMS] = config.stash[_CLAIMS_DIR]


class _RunOnce:
    def __init__(self, claims):
        self.claims = claims

    @pytest.hookimpl(tryfirst=True)
    def pytest_runtest_protocol(self, item, nextitem):
        name = hashlib.sha1(item.nodeid.encode()).hexdigest()
        try:
            os.close(os.open(os.path.join(self.claims, name), os.O_CREAT | os.O_EXCL))
        except FileExistsError:
            return True  # it crashed a worker, and xdist has reported it failed
        return None


def _arm(item, seconds):
    faulthandler.dump_traceback_later(
        seconds,
        exit="PYTEST_XDIST_WORKER" in os.environ,
        file=item.config.stash[_STDERR],
    )


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    item.stash[_DEADLINE] = time.monotonic() + LIMIT_S
    _arm(item, LIMIT_S)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()


@pytest.hookimpl(trylast=True)
def pytest_exception_interact(node, call, report):
    # pytest's faulthandler plugin cancels the timer whenever a phase fails;
    # re-arm it so the teardown that follows stays under the same deadline.
    if isinstance(node, pytest.Item) and _DEADLINE in node.stash:
        left = node.stash[_DEADLINE] - time.monotonic()
        if left > 0:
            _arm(node, left)


def _write_file_seconds(junit_xml):
    seconds = collections.Counter()
    for case in xml.etree.ElementTree.parse(junit_xml).iter("testcase"):
        module = case.get("classname").split(".")[1]  # tests.<module>[.<class>]
        seconds[module + ".py"] += float(case.get("time", 0))
    with open(FILE_SECONDS, "w") as f:
        json.dump({k: round(v) for k, v in seconds.most_common()}, f, indent=0)
        f.write("\n")


if __name__ == "__main__":
    _write_file_seconds(sys.argv[1])
