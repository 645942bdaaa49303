"""Run a command until it exits 0 (crash-resume wrapper).

A copy of ``human_dynamics_tpu/utils/autorestart.py`` (the reference's
src/evaluation/autorestart.py:6-15) —
works because the eval/demo pipelines are idempotent (pkl caches).

Usage: python -m human_dynamics_tpu_torch.utils.autorestart <cmd> [args...]
"""

from __future__ import annotations

import subprocess
import sys
import time


def restart_until_success(cmd, max_tries: int = 0, backoff: float = 5.0):
    tries = 0
    while True:
        ret = subprocess.call(cmd)
        if ret == 0:
            return 0
        tries += 1
        print(f"[autorestart] exit {ret}; retry #{tries} in {backoff}s")
        if max_tries and tries >= max_tries:
            return ret
        time.sleep(backoff)


if __name__ == "__main__":
    sys.exit(restart_until_success(sys.argv[1:]))
