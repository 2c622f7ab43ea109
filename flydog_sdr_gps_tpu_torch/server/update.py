"""Auto-update machinery (`net/update.cpp:107-270` analogue).

The reference's update task: preflight checks (filesystem full,
internet reachable, git clone intact), fetch origin, read the remote
Makefile's VERSION_MAJ/MIN, compare, optionally `make install`, log
everything to its build log, surface an `update_cb` JSON to the
admin UI, restart the server on success.  Updates run either forced
from the admin tab or inside a scheduled overnight window.

This implementation keeps the exact state machine — fail reasons,
check vs. build, install-enable gate, schedule window, build-log
surfacing, restart request — with the COMMAND RUNNER injected so the
logic is unit-testable offline (the build environment has no egress;
a real deployment passes a subprocess runner).
"""

from __future__ import annotations

import os
import re
import time

from .. import __version__

# fail reasons (update.cpp FAIL_*)
FAIL_NONE = 0
FAIL_FS_FULL = 1
FAIL_NO_INET = 2
FAIL_NO_GITHUB = 3
FAIL_GIT = 4
FAIL_MAKEFILE = 5
FAIL_BUILD = 6


def parse_version(text: str) -> tuple[int, int] | None:
    """Extract (maj, min) from a remote version file — accepts the
    reference's "VERSION_MAJ = n / VERSION_MIN = n" Makefile form or
    this package's `__version__ = "maj.min.x"` line."""
    m = re.search(r"VERSION_MAJ\s*=\s*(\d+).*?VERSION_MIN\s*=\s*(\d+)",
                  text, re.S)
    if m:
        return int(m.group(1)), int(m.group(2))
    m = re.search(r"__version__\s*=\s*[\"'](\d+)\.(\d+)", text)
    if m:
        return int(m.group(1)), int(m.group(2))
    return None


class UpdateManager:
    """State machine of the reference's _update_task.

    ``runner(cmd: str) -> (rc, output)`` runs a shell step; every
    step's output is appended to the build log (the reference's
    build log, surfaced in the admin update tab).
    """

    #: overnight install window, hours (update task schedule)
    WINDOW = (1, 6)

    def __init__(self, runner=None, install_enabled: bool = False,
                 repo_dir: str | None = None):
        # the checkout this package was imported from
        if repo_dir is None:
            repo_dir = os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
        self.runner = runner
        self.install_enabled = install_enabled
        self.repo_dir = repo_dir
        self.version = self._cur_version()
        self.pending: tuple[int, int] | None = None
        self.fail_reason = FAIL_NONE
        self.in_progress = False
        self.update_pending = False
        self.build_log: list[str] = []
        self.restart_requested = False

    @staticmethod
    def _cur_version() -> tuple[int, int]:
        v = parse_version(f'__version__ = "{__version__}"')
        return v or (0, 0)

    def _run(self, tag: str, cmd: str) -> int:
        if self.runner is None:
            self.build_log.append(f"[{tag}] SKIPPED (no egress)")
            return 1
        rc, out = self.runner(cmd)
        self.build_log.append(f"[{tag}] rc={rc}")
        if out:
            self.build_log.extend(str(out).splitlines()[-50:])
        return rc

    def status(self) -> dict:
        """The admin `update_cb` payload (update.cpp report_result)."""
        return {"f": self.fail_reason, "p": int(self.update_pending),
                "i": int(self.in_progress),
                "v1": self.version[0], "v2": self.version[1],
                "p1": self.pending[0] if self.pending else 0,
                "p2": self.pending[1] if self.pending else 0}

    def in_window(self, now: float | None = None) -> bool:
        hour = time.localtime(now or time.time()).tm_hour
        return self.WINDOW[0] <= hour < self.WINDOW[1]

    def check(self, force_build: bool = False) -> dict:
        """One update pass: preflight -> fetch -> version compare ->
        (optionally) build + restart.  Returns status()."""
        self.fail_reason = FAIL_NONE
        self.in_progress = True
        try:
            cd = f"cd {self.repo_dir}; "
            # preflight: filesystem full? (update.cpp FS_USE)
            if self._run("ck_fs",
                         cd + "df . | tail -1 | tr -s ' ' | "
                         "cut -d' ' -f5 | grep -q 100%") == 0:
                self.fail_reason = FAIL_FS_FULL
                return self.status()
            # internet + git reachability (PING_INET / PING_GITHUB)
            if self._run("ck_inet", "ping -qc2 -W2 1.1.1.1") != 0 and \
                    self._run("ck_inet2", "ping -qc2 -W2 8.8.8.8") != 0:
                self.fail_reason = FAIL_NO_INET
                return self.status()
            if self._run("ck_git", cd + "git fetch origin") != 0:
                self.fail_reason = FAIL_NO_GITHUB
                return self.status()
            # remote version (fetch_makefile_ctask analogue)
            if self.runner is None:
                self.fail_reason = FAIL_MAKEFILE
                return self.status()
            rc, out = self.runner(
                cd + "git show origin/main:flydog_sdr_gps_tpu_torch/"
                "__init__.py")
            self.build_log.append(f"[ver] rc={rc}")
            if rc != 0:
                self.fail_reason = FAIL_MAKEFILE
                return self.status()
            pending = parse_version(str(out))
            if pending is None:
                self.fail_reason = FAIL_MAKEFILE
                return self.status()
            self.pending = pending
            changed = pending > self.version
            if changed and not self.install_enabled and \
                    not force_build:
                self.update_pending = True
                return self.status()
            if changed or force_build:
                if self._run("build", cd + "git merge --ff-only "
                             "origin/main && python -m pytest tests/ "
                             "-x -q") != 0:
                    self.fail_reason = FAIL_BUILD
                    return self.status()
                self.build_log.append("======== build complete")
                self.update_pending = False
                self.restart_requested = True
            return self.status()
        finally:
            self.in_progress = False
