"""Wedge-recovery supervisor of the PyTorch port (port of
``qmcnn_tpu/supervise.py``): an auto-restarting wrapper around the trainer.

  python -m qmcnn_tpu_torch.supervise --config configs/foo.yaml \
      [--override section.key=value ...] [--device cuda|cpu] \
      [--stall-timeout 900] [--startup-timeout 1800] [--max-restarts 5]

The failure mode it exists for: a device call wedges — the process blocks
inside it forever, with no exception and no output. The watchdog in
``train.py`` can only warn (a blocked call cannot be interrupted from
inside the process); recovery needs the process killed and the run
resumed from its last checkpoint. This module automates that loop:

  1. run ``python -m qmcnn_tpu_torch.train`` as a child in its own process
     group (session), with ``run.heartbeat_path`` pointed at a liveness
     file that train() rewrites after every completed chunk of steps;
  2. poll the heartbeat. If it goes stale for longer than --stall-timeout
     (or --startup-timeout before the first beat, which covers the warm
     start, thermalization and the kernels' build), SIGKILL the child's
     process group (its exact pgid, never a pattern) and start a fresh
     child, which resumes from ``run.ckpt_dir`` through the normal
     CheckpointManager.restore path;
  3. a restart whose heartbeat *advanced past the previous best step*
     refunds the restart budget: a long run survives any number of
     spaced-out wedges, while a crash loop (no progress) stops after
     --max-restarts.

Monte Carlo makes this safe: the per-step keys derive from state.step, so a
resumed run continues the same stream from the checkpointed step; only the
steps after the checkpoint are recomputed.

The JAX supervisor holds the TPU host's chip lock (``utils/chip_lock.py``)
for its lifetime and marks its child as holding it. The port has no chip
lock (that module is TPU-only and stays unported), so ``main`` acquires
nothing and the child's environment is this process's.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence


def read_heartbeat(path: str):
    """Returns (step, mtime) or None if the file is absent/unparsable."""
    try:
        with open(path) as f:
            step = int(f.read().split()[0])
        return step, os.path.getmtime(path)
    except (OSError, ValueError, IndexError):
        return None


class Supervisor:
    """Run ``argv`` as a heartbeat-monitored child; restart on stall/crash.

    Parameters
    ----------
    argv: the child command line (already including the heartbeat override).
    heartbeat_path: file the child rewrites after each chunk of steps.
    stall_timeout: seconds without a heartbeat update after the first beat
        before the child is declared wedged.
    startup_timeout: seconds allowed before the *first* beat of each child
        (the warm start, thermalization and the kernels' build).
    max_restarts: restarts allowed without step progress before giving up.
    device_wait: if > 0, before each attempt probe the device with
        ``device_probe_cmd`` and hold the launch (without consuming restart
        budget) until the probe succeeds or ``device_wait`` seconds pass, so
        a device that is down for a while does not spend the budget on
        doomed children.
    """

    def __init__(self, argv: Sequence[str], heartbeat_path: str,
                 stall_timeout: float = 900.0,
                 startup_timeout: float = 1800.0,
                 max_restarts: int = 5, poll_s: float = 5.0,
                 device_wait: float = 0.0,
                 device_probe_cmd: Optional[Sequence[str]] = None,
                 probe_timeout: float = 1800.0,
                 log=print):
        self.argv = list(argv)
        self.heartbeat_path = heartbeat_path
        self.stall_timeout = stall_timeout
        self.startup_timeout = startup_timeout
        self.max_restarts = max_restarts
        self.poll_s = poll_s
        self.device_wait = device_wait
        self.device_probe_cmd = (
            list(device_probe_cmd) if device_probe_cmd is not None else
            [sys.executable, "-c",
             "import torch; assert torch.cuda.device_count() > 0"])
        self.probe_timeout = probe_timeout
        self.log = log
        self._child: Optional[subprocess.Popen] = None

    def _wait_for_device(self) -> None:
        """Block until the device answers a probe (or the budget expires).

        Never raises; a device still dead after ``device_wait`` seconds
        falls through to a normal attempt (which then fails and counts).
        """
        if self.device_wait <= 0:
            return
        deadline = time.monotonic() + self.device_wait
        first = True
        while True:
            try:
                rc = subprocess.run(
                    self.device_probe_cmd, timeout=self.probe_timeout,
                    stdout=subprocess.DEVNULL,
                    stderr=subprocess.DEVNULL).returncode
            except subprocess.TimeoutExpired:
                rc = -1
            if rc == 0:
                if not first:
                    self.log("supervise: device probe OK — launching")
                return
            first = False
            if time.monotonic() > deadline:
                self.log(f"supervise: device still unavailable after "
                         f"{self.device_wait:.0f}s of probing — launching "
                         "anyway")
                return
            self.log("supervise: device unavailable (probe failed) — "
                     f"retrying in {self.poll_s:.0f}s without consuming "
                     "restart budget")
            time.sleep(self.poll_s)

    def _kill(self, child: subprocess.Popen) -> None:
        # The child was started with start_new_session=True, so its pgid is
        # its own pid: killpg reaps it and anything it forked, and cannot
        # touch this process.
        try:
            os.killpg(child.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        child.wait()

    def _install_term_handlers(self) -> None:
        """Kill the live child's process group when the supervisor itself is
        told to die: a ``timeout N supervise`` would otherwise reap only the
        supervisor and orphan the train child (its own process group
        survives the parent), which keeps the device busy while the next
        job starts."""
        def _on_term(signum, frame):
            child = self._child
            if child is not None and child.poll() is None:
                try:
                    os.killpg(child.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
            raise SystemExit(128 + signum)

        for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP):
            try:
                signal.signal(sig, _on_term)
            except (ValueError, OSError):  # non-main thread / exotic env
                pass

    def run(self) -> int:
        restarts_without_progress = 0
        best_step = -1
        attempt = 0
        self._child = None
        self._install_term_handlers()
        while True:
            attempt += 1
            self._wait_for_device()
            # Stale heartbeat from a previous child must not look live.
            try:
                os.remove(self.heartbeat_path)
            except OSError:
                pass
            self.log(f"supervise: starting attempt {attempt}: "
                     f"{' '.join(self.argv)}")
            child = subprocess.Popen(self.argv, start_new_session=True)
            self._child = child
            started = time.monotonic()
            seen_beat = False
            last_hb = None
            wedged = False
            while True:
                rc = child.poll()
                if rc is not None:
                    break
                time.sleep(self.poll_s)
                hb = read_heartbeat(self.heartbeat_path)
                now = time.monotonic()
                if hb is None and last_hb is not None:
                    # A transient unreadable/missing file after beats have
                    # been seen must NOT re-enter the startup branch (a
                    # glitchy read there past startup_timeout would kill a
                    # live child instantly); judge staleness from the last
                    # known beat instead.
                    hb = last_hb
                if hb is None:
                    if now - started > self.startup_timeout:
                        exists = os.path.exists(self.heartbeat_path)
                        self.log(f"supervise: no first heartbeat within "
                                 f"{self.startup_timeout:.0f}s — killing "
                                 f"pid {child.pid} (heartbeat file "
                                 f"{'exists but unreadable' if exists else 'absent'}: "
                                 f"{self.heartbeat_path})")
                        self._kill(child)
                        wedged = True
                        break
                    continue
                if not seen_beat:
                    self.log(f"supervise: first heartbeat at step {hb[0]} "
                             f"({now - started:.0f}s after launch)")
                seen_beat = True
                last_hb = hb
                step, mtime = hb
                stale = time.time() - mtime
                if stale > self.stall_timeout:
                    self.log(f"supervise: heartbeat stale {stale:.0f}s at "
                             f"step {step} — killing pid {child.pid} and "
                             "resuming from checkpoint")
                    self._kill(child)
                    wedged = True
                    break
            if not wedged:
                rc = child.returncode
                if rc == 0:
                    self.log(f"supervise: child completed (attempt "
                             f"{attempt})")
                    return 0
                self.log(f"supervise: child exited rc={rc}")
            # progress since the last restart refunds the budget
            hb = read_heartbeat(self.heartbeat_path)
            step = hb[0] if (hb is not None and seen_beat) else -1
            if step > best_step:
                best_step = step
                restarts_without_progress = 0
            restarts_without_progress += 1
            if restarts_without_progress > self.max_restarts:
                self.log(f"supervise: giving up after "
                         f"{restarts_without_progress - 1} restarts without "
                         f"progress (best step {best_step})")
                return 1


def _default_heartbeat_path(cfg) -> str:
    # the JAX supervisor's /tmp, through TMPDIR
    base = cfg.run.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                            f"qmcnn_{cfg.name}")
    os.makedirs(base, exist_ok=True)
    return os.path.join(base, "heartbeat")


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True)
    p.add_argument("--override", action="append", default=[],
                   metavar="section.key=value")
    p.add_argument("--device", default="cuda",
                   help="torch device of the child (default cuda; 'cpu' to "
                        "run there)")
    p.add_argument("--stall-timeout", type=float, default=900.0)
    p.add_argument("--startup-timeout", type=float, default=1800.0)
    p.add_argument("--max-restarts", type=int, default=5)
    p.add_argument("--poll", type=float, default=5.0)
    p.add_argument("--device-wait", type=float, default=0.0,
                   help="seconds to hold each launch while a device probe "
                        "fails (0 = launch immediately); probing does not "
                        "consume the restart budget")
    args = p.parse_args(argv)

    from qmcnn_tpu_torch import configs as cfglib

    cfg = cfglib.load(args.config, tuple(args.override))
    if not cfg.run.ckpt_dir:
        print("supervise: WARNING — run.ckpt_dir is null; a restarted child "
              "re-trains from step 0 (set ckpt_dir to make restarts resume)",
              flush=True)
    hb = (cfg.run.heartbeat_path
          or _default_heartbeat_path(cfg))
    child_argv = [sys.executable, "-m", "qmcnn_tpu_torch.train",
                  "--config", args.config, "--device", args.device]
    for ov in args.override:
        child_argv += ["--override", ov]
    child_argv += ["--override", f"run.heartbeat_path={hb}"]
    sup = Supervisor(child_argv, hb,
                     stall_timeout=args.stall_timeout,
                     startup_timeout=args.startup_timeout,
                     max_restarts=args.max_restarts, poll_s=args.poll,
                     device_wait=args.device_wait)
    return sup.run()


if __name__ == "__main__":
    raise SystemExit(main())
