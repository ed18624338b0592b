"""Provenance stamp for validation records.

Every `validation/*.json` carries the git SHA and tree state of the run
that produced it, so a drifted solver cannot silently hide behind a
stale recorded number (the recorded-validation tests assert these
records; the slow tier re-runs physics from scratch).  A source copy
without its git metadata (a run on another machine) takes the stamp from
PETIBM_GIT_SHA and PETIBM_GIT_DIRTY, set by whoever made the copy.
"""

from __future__ import annotations

import datetime
import os
import subprocess

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def provenance() -> dict:
    def git(*args: str) -> str:
        try:
            return subprocess.run(
                ["git", "-C", REPO, *args], capture_output=True, text=True,
                timeout=10).stdout.strip()
        except Exception:
            return ""

    sha = git("rev-parse", "HEAD")
    if sha:
        dirty = bool(git("status", "--porcelain", "--untracked-files=no"))
    else:
        sha = os.environ.get("PETIBM_GIT_SHA", "")
        dirty = os.environ.get("PETIBM_GIT_DIRTY", "1") != "0"
    return {
        "git_sha": sha or None,
        "dirty_tree": dirty,
        "recorded_utc": datetime.datetime.now(
            datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ"),
    }
