"""The suite's per-test time limit (tests/_suite_limits.py) under xdist.

A pytest run in a subprocess, on a directory of its own, with the limit loaded
by ``-p _suite_limits`` (and lowered to 5 s by that directory's conftest) and
the tier-1 command's ``--dist loadfile`` on two workers. A test that sleeps
past the limit kills its worker, is reported failed once, and the tests around
it still run. A test marked ``slow`` does not run under ``-m 'not slow'``.

The files are laid out so that the crash comes while the other worker is alive
and short of work: xdist then hands it the crashed test's file at once, before
the worker that crashed is replaced, and that worker must not run the hang
again. No file here has measured seconds, so the files go out in name order:
one worker takes ``test_a_hang.py``, the other ``test_b_waits.py`` and
``test_c_outlasts.py``, and, when the hang has begun, ``test_d_last.py``, the
last in the queue.
"""

import os
import re
import subprocess
import sys
import textwrap
import time

_TESTS_DIR = os.path.dirname(os.path.abspath(__file__))

_CONFTEST = "import _suite_limits\n\n_suite_limits.LIMIT_S = 5.0\n"

_HELPERS = textwrap.dedent(
    """
    import fcntl
    import pathlib
    import time

    HERE = pathlib.Path(__file__).parent
    LOCK = HERE / "hang.lock"  # held by the hang until its worker dies
    STARTED = HERE / "hang.started"


    def hang_is_over():
        if not STARTED.exists():
            return False
        with open(LOCK, "a") as f:
            try:
                fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except BlockingIOError:
                return False
        return True


    def wait_for(condition, seconds=4.5):
        end = time.monotonic() + seconds
        while not condition() and time.monotonic() < end:
            time.sleep(0.05)
    """
)

_HANG = textwrap.dedent(
    """
    import fcntl
    import time

    import pytest

    from _helpers import LOCK, STARTED


    def test_before():
        pass


    def test_sleeps_past_its_limit():
        with open(LOCK, "a") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            STARTED.touch()
            time.sleep(60)


    def test_after_1():
        pass


    def test_after_2():
        pass


    @pytest.mark.slow
    def test_marked_slow():
        pass
    """
)

_WAITS = textwrap.dedent(
    """
    import time

    from _helpers import STARTED, wait_for


    def test_waits_for_the_hang():
        wait_for(STARTED.exists)
        time.sleep(3)
    """
)

_OUTLASTS = textwrap.dedent(
    """
    import time

    from _helpers import hang_is_over, wait_for


    def test_outlasts_the_crash():
        # Still running while xdist handles the crash: this worker is then
        # neither idle nor shutting down, so it is handed the crashed file.
        wait_for(hang_is_over)
        time.sleep(2)
    """
)

_LAST = "def test_one():\n    pass\n"


def test_hang_fails_once_and_the_run_goes_on(tmp_path):
    (tmp_path / "pytest.ini").write_text(  # the run's rootdir
        "[pytest]\nmarkers =\n    slow: left out by -m 'not slow'\n"
    )
    files = {
        "conftest.py": _CONFTEST,
        "_helpers.py": _HELPERS,
        "test_a_hang.py": _HANG,
        "test_b_waits.py": _WAITS,
        "test_c_outlasts.py": _OUTLASTS,
        "test_d_last.py": _LAST,
    }
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_TESTS_DIR, env.get("PYTHONPATH")) if p
    )
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m", "pytest", str(tmp_path), "-q", "-rA",
         "-p", "_suite_limits", "-p", "xdist", "-n", "2", "--dist", "loadfile",
         "-p", "no:cacheprovider", "-p", "no:randomly", "-m", "not slow"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=60,
    )
    seconds = time.monotonic() - t0
    text = out.stdout + out.stderr
    summary = out.stdout.strip().splitlines()[-1]
    assert re.search(r"\b1 failed\b", summary), text
    assert re.search(r"\b6 passed\b", summary), text
    crashes = re.findall(r"crashed while running '([^']*)'", text)
    assert crashes == ["test_a_hang.py::test_sleeps_past_its_limit"], text
    # xdist's summary counts no deselection: the slow test is simply absent.
    assert "test_marked_slow" not in text
    assert seconds < 30, (seconds, text)
