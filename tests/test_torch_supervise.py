"""PyTorch port, slice 14: the wedge-recovery supervisor
(``qmcnn_tpu_torch/supervise.py``) and the train loop's liveness
(heartbeat, events, the save settle, the dispatch watchdog, the
auto-sized chunk).

The supervisor scenarios of ``tests/test_supervise.py`` (clean, stall then
resume, no first beat, crash loop, refund, device wait twice, glitch,
SIGTERM, read_heartbeat) run with both packages' ``Supervisor`` on the
same stub children, each held to the same rc, last heartbeat step and
number of attempts. Their timeouts are shorter than the JAX file's (sub-
second polls, 1-2 s timeouts), so every case stays in the fast tier. The
train-loop tests run the JAX and the port loop on one tiny config and
compare what they write (exact equality: step numbers, event names,
heartbeat steps)."""
import csv
import json
import os
import signal
import stat
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from qmcnn_tpu import configs as jcfg
from qmcnn_tpu import supervise as jsup
from qmcnn_tpu import train as jtrain
from qmcnn_tpu_torch import configs as tcfg
from qmcnn_tpu_torch import supervise as tsup
from qmcnn_tpu_torch import train as ttrain
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": jsup, "torch": tsup}


def _stub(tmp_path, name, body):
    """An executable python stub; argv[1] = heartbeat, argv[2] = state dir."""
    path = tmp_path / name
    path.write_text(textwrap.dedent(f"""\
        import os, sys, time
        hb = sys.argv[1]
        state = sys.argv[2]
        def beat(step):
            with open(hb, "w") as f:
                f.write(f"{{step}} {{time.time()}}\\n")
        {textwrap.indent(textwrap.dedent(body), '        ').strip()}
        """))
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def _run(pkg, tmp_path, body, **kw):
    """(rc, last heartbeat step or None, attempts) of ``pkg``'s Supervisor
    over the stub ``body``."""
    hb = str(tmp_path / "hb")
    script = _stub(tmp_path, "child.py", body)
    logs = []
    sup = PACKAGES[pkg].Supervisor([sys.executable, script, hb,
                                    str(tmp_path)], hb,
                                   poll_s=kw.pop("poll_s", 0.1),
                                   log=logs.append, **kw)
    rc = sup.run()
    beat = PACKAGES[pkg].read_heartbeat(hb)
    attempts = sum(line.startswith("supervise: starting attempt")
                   for line in logs)
    return rc, None if beat is None else beat[0], attempts


SCENARIOS = {
    # name: (stub body, Supervisor kwargs, (rc, last step, attempts))
    "clean_first_try": ("""
        beat(1); beat(2)
        sys.exit(0)
    """, dict(stall_timeout=60, startup_timeout=60, max_restarts=1),
        (0, 2, 1)),
    # beats to step 3 then wedges; the restart finds the "checkpoint"
    "stall_then_resume": ("""
        marker = os.path.join(state, "ckpt_marker")
        if os.path.exists(marker):
            beat(6)
            sys.exit(0)
        open(marker, "w").close()
        beat(3)
        time.sleep(600)
    """, dict(stall_timeout=1.0, startup_timeout=30, max_restarts=2),
        (0, 6, 2)),
    # never beats (wedged in its start); the second attempt succeeds
    "no_first_heartbeat": ("""
        marker = os.path.join(state, "ckpt_marker")
        if os.path.exists(marker):
            beat(1)
            sys.exit(0)
        open(marker, "w").close()
        time.sleep(600)
    """, dict(stall_timeout=60, startup_timeout=1.5, max_restarts=3),
        (0, 1, 2)),
    "crash_loop_gives_up": ("""
        sys.exit(3)
    """, dict(stall_timeout=5, startup_timeout=5, max_restarts=2),
        (1, None, 3)),
    # every child advances one step and wedges: max_restarts=1 suffices
    "progress_refunds_budget": ("""
        cnt = os.path.join(state, "count")
        n = int(open(cnt).read()) if os.path.exists(cnt) else 0
        open(cnt, "w").write(str(n + 1))
        beat(n + 1)
        if n + 1 >= 4:
            sys.exit(0)
        time.sleep(600)
    """, dict(stall_timeout=0.6, startup_timeout=30, max_restarts=1),
        (0, 4, 4)),
    # a missing beat after beats were seen is judged from the last beat,
    # not the startup branch (max_restarts=0: any kill fails)
    "transient_glitch_does_not_kill": ("""
        beat(1)
        time.sleep(1.5)   # past startup_timeout
        os.remove(hb)     # the glitch: several polls see no file
        time.sleep(0.6)
        beat(2)
        sys.exit(0)
    """, dict(stall_timeout=60, startup_timeout=1.0, max_restarts=0),
        (0, 2, 1)),
}


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_supervisor_scenarios_match_jax(name, pkg, tmp_path):
    body, kw, want = SCENARIOS[name]
    assert _run(pkg, tmp_path, body, **kw) == want


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
@pytest.mark.parametrize("fails,wait,probes", [(2, 60, 3), (None, 0.2, None)])
def test_device_wait(pkg, fails, wait, probes, tmp_path):
    """The probe fails ``fails`` times before the device "recovers"
    (None: it never does, and the launch goes ahead after ``wait``); with
    max_restarts=0 the run still succeeds, since probing holds the launch
    without spending an attempt."""
    cnt = tmp_path / "probes"
    exit_code = ("0 if n >= %d else 1" % fails) if fails else "1"
    probe = _stub(tmp_path, "probe.py", f"""
        n = int(open(state).read()) if os.path.exists(state) else 0
        open(state, "w").write(str(n + 1))
        sys.exit({exit_code})
    """)
    hb = str(tmp_path / "hb")
    child = _stub(tmp_path, "child.py", """
        beat(1)
        sys.exit(0)
    """)
    sup = PACKAGES[pkg].Supervisor(
        [sys.executable, child, hb, str(tmp_path)], hb, poll_s=0.05,
        log=lambda *a: None, stall_timeout=30, startup_timeout=30,
        max_restarts=0, device_wait=wait,
        device_probe_cmd=[sys.executable, probe, "unused", str(cnt)])
    assert sup.run() == 0
    if probes is not None:
        assert int(cnt.read_text()) == probes  # 2 failures + 1 success


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_read_heartbeat_robust(pkg, tmp_path):
    read = PACKAGES[pkg].read_heartbeat
    assert read(str(tmp_path / "missing")) is None
    bad = tmp_path / "bad"
    bad.write_text("not-a-step\n")
    assert read(str(bad)) is None
    good = tmp_path / "good"
    good.write_text("7 123.5\n")
    assert read(str(good))[0] == 7


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_sigterm_reaps_the_child(pkg, tmp_path):
    """SIGTERM to the supervisor kills the child's whole process group and
    exits 128 + SIGTERM."""
    hb = str(tmp_path / "hb")
    child = _stub(tmp_path, "child.py", """
        with open(os.path.join(state, "childpid"), "w") as f:
            f.write(str(os.getpid()))
        time.sleep(120)
    """)
    module = PACKAGES[pkg].__name__
    driver = tmp_path / "driver.py"
    driver.write_text(textwrap.dedent(f"""\
        import sys
        sys.path.insert(0, {ROOT!r})
        from {module} import Supervisor
        sup = Supervisor([sys.executable, {child!r}, {hb!r},
                          {str(tmp_path)!r}], {hb!r}, poll_s=0.1,
                         startup_timeout=60, log=lambda *a, **k: None)
        sys.exit(sup.run())
        """))
    proc = subprocess.Popen([sys.executable, str(driver)])
    pidfile = tmp_path / "childpid"
    deadline = time.time() + 60
    while not pidfile.exists() and time.time() < deadline:
        time.sleep(0.05)
    assert pidfile.exists(), "child never started"
    child_pid = int(pidfile.read_text())
    time.sleep(0.2)
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=30) == 128 + signal.SIGTERM
    deadline = time.time() + 10
    while time.time() < deadline:
        try:
            os.kill(child_pid, 0)
        except ProcessLookupError:
            break
        time.sleep(0.05)
    else:
        os.kill(child_pid, 9)  # clean up before failing
        raise AssertionError("supervisor SIGTERM orphaned its child")


def test_main_builds_the_port_child(tmp_path, monkeypatch):
    """``main`` runs ``python -m qmcnn_tpu_torch.train`` with --device and
    the heartbeat override, and acquires no lock (the port has none)."""
    seen = {}

    class Recorder:
        def __init__(self, argv, hb, **kw):
            seen.update(argv=argv, hb=hb, kw=kw)

        def run(self):
            return 0

    monkeypatch.setattr(tsup, "Supervisor", Recorder)
    cfg = os.path.join(ROOT, "configs", "tfim16_sgd.yaml")
    ck = str(tmp_path / "ck")
    assert tsup.main(["--config", cfg, "--device", "cpu", "--override",
                      f"run.ckpt_dir={ck}", "--stall-timeout", "7",
                      "--poll", "0.5"]) == 0
    argv = seen["argv"]
    assert argv[1:3] == ["-m", "qmcnn_tpu_torch.train"]
    assert argv[argv.index("--device") + 1] == "cpu"
    assert seen["hb"] == os.path.join(ck, "heartbeat")
    assert argv[-1] == f"run.heartbeat_path={seen['hb']}"
    assert seen["kw"]["stall_timeout"] == 7 and seen["kw"]["poll_s"] == 0.5


# -- the train loop's liveness ------------------------------------------------

HB_YAML = """
name: hbsmoke
lattice: {{shape: [8]}}
model: {{channels: [4]}}
hamiltonian: {{kind: tfim, h: 1.0}}
sampler: {{n_walkers: 32, move: flip, n_therm_sweeps: 2}}
optimizer: {{kind: sgd, lr: 0.05}}
run: {{n_steps: {n_steps}, steps_per_dispatch: {per}, log_every: 1,
       heartbeat_path: '{hb}', csv_path: '{csv}', validate_against_ed: true,
       ckpt_every: 2, save_settle_s: {settle}}}
"""


def _events(path):
    with open(path) as f:
        return [line.split()[1:3] for line in f]


def _both(tmp_path, n_steps=4, per=2, settle=0.0, ckpt=False):
    """Train the HB_YAML config in both packages; per package (csv path,
    heartbeat path)."""
    from qmcnn_tpu.utils.checkpoint import CheckpointManager as JCkpt
    from qmcnn_tpu_torch.utils.checkpoint import CheckpointManager as TCkpt

    out = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        d.mkdir()
        hb, csv_path = str(d / "hb"), str(d / "m.csv")
        text = HB_YAML.format(n_steps=n_steps, per=per, hb=hb, csv=csv_path,
                              settle=settle)
        if pkg == "jax":
            cfg = jcfg.from_yaml(text)
            ck = JCkpt(str(d / "ck")) if ckpt else None
            jtrain.train(cfg, ckpt_manager=ck)
            if ck is not None:
                ck.close()
        else:
            cfg = tcfg.from_yaml(text)
            ck = TCkpt(str(d / "ck")) if ckpt else None
            ttrain.train(cfg, device="cpu", ckpt_manager=ck)
        out[pkg] = (csv_path, hb)
    return out


def _csv_steps(path):
    with open(path) as f:
        return [int(r["step"]) for r in csv.DictReader(f)]


def test_train_heartbeat_events_and_manifest(tmp_path):
    """The port's train() with run.heartbeat_path: the last beat reads
    n_steps, '<heartbeat>.events' holds JAX's lines (name, step) in JAX's
    order, with each save bracketed and pinged, and the manifest beside
    the CSV."""
    runs = _both(tmp_path, ckpt=True, settle=0.01)
    (jcsv, jhb), (tcsv, thb) = runs["jax"], runs["torch"]
    assert tsup.read_heartbeat(thb)[0] == 4 == jsup.read_heartbeat(jhb)[0]
    assert _events(thb + ".events") == _events(jhb + ".events")
    names = {e[0] for e in _events(thb + ".events")}
    assert names == {"dispatch_start", "dispatch_end", "save_start",
                     "save_end", "save_ping"}
    with open(thb + ".events") as f:
        ping = [line.split() for line in f if " save_ping " in line]
    assert ping and all(p[3].endswith("s") for p in ping)
    with open(tcsv + ".meta.json") as f:
        meta = json.load(f)
    assert meta["name"] == "hbsmoke" and meta["torch_version"]
    assert meta["rel_err"] is not None
    assert "n_walkers: 32" in meta["config"]


def test_auto_steps_per_dispatch_logs_jax_steps(tmp_path, capsys):
    """steps_per_dispatch=0: two timed single-step chunks go unlogged and
    the heartbeat reads 2 after them; the CSV rows are JAX's step numbers
    exactly."""
    runs = _both(tmp_path, n_steps=5, per=0)
    steps = {pkg: _csv_steps(csv_path) for pkg, (csv_path, _) in runs.items()}
    assert steps["torch"] == steps["jax"] == [3, 4, 5]
    assert "auto steps_per_dispatch: per-step" in capsys.readouterr().out
    events = _events(runs["torch"][1] + ".events")
    assert events[0] == ["dispatch_start", "2"]


def test_dispatch_watchdog_warns_on_a_stalled_chunk(tmp_path, monkeypatch,
                                                    capsys):
    """A chunk that outlasts run.dispatch_warn_s prints the watchdog's
    warning (a monkeypatched slow run_steps stands for a stalled device);
    every chunk's timer is cancelled when the chunk ends, so a fast run
    with a long limit prints none."""
    import threading

    from qmcnn_tpu_torch.vmc import VMC

    text = HB_YAML.format(n_steps=2, per=1, hb=str(tmp_path / "hb"),
                          csv=str(tmp_path / "m.csv"), settle=0.0)
    timers = []

    class Timer(threading.Timer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            timers.append(self)

    monkeypatch.setattr(threading, "Timer", Timer)
    ttrain.train(tcfg.from_yaml(text), device="cpu")  # dispatch_warn_s 300
    assert len(timers) == 2 and all(t.finished.is_set() for t in timers)
    assert "WARNING: dispatch at step" not in capsys.readouterr().out
    run_steps = VMC.run_steps

    def slow(self, *args, **kw):
        time.sleep(0.6)
        return run_steps(self, *args, **kw)

    monkeypatch.setattr(VMC, "run_steps", slow)
    cfg = tcfg.apply_overrides(tcfg.from_yaml(text),
                               ("run.dispatch_warn_s=0.2",))
    ttrain.train(cfg, device="cpu")
    out = capsys.readouterr().out
    assert "WARNING: dispatch at step 0 has been blocked for > 0s" in out
    assert "the device may have stalled" in out
    assert "WARNING: dispatch at step 1 has been blocked" in out
    cfg = tcfg.apply_overrides(cfg, ("run.dispatch_warn_s=0",))
    ttrain.train(cfg, device="cpu")
    assert "WARNING" not in capsys.readouterr().out  # 0 disables it


def test_save_settle_pings_and_sleeps(tmp_path, monkeypatch):
    """Each periodic save is followed by a save_ping event and a
    run.save_settle_s sleep; the final save by neither (as in JAX)."""
    from qmcnn_tpu_torch.utils.checkpoint import CheckpointManager

    slept, real_sleep = [], time.sleep

    def sleep(seconds):  # the settle's sleeps recorded, the others slept
        if sys._getframe(1).f_code.co_name == "_post_save_settle":
            slept.append(seconds)
        else:
            real_sleep(seconds)

    monkeypatch.setattr(ttrain.time, "sleep", sleep)
    text = HB_YAML.format(n_steps=4, per=1, hb=str(tmp_path / "hb"),
                          csv=str(tmp_path / "m.csv"), settle=0.25)
    cfg = tcfg.from_yaml(text)
    ttrain.train(cfg, device="cpu",
                 ckpt_manager=CheckpointManager(str(tmp_path / "ck")))
    events = _events(str(tmp_path / "hb.events"))
    assert [e for e in events if e[0] == "save_ping"] == [
        ["save_ping", "2"], ["save_ping", "4"]]
    assert events[-2:] == [["save_start", "4"], ["save_end", "4"]]
    assert slept == [0.25, 0.25]
    assert np.isfinite(_csv_steps(str(tmp_path / "m.csv"))).all()
