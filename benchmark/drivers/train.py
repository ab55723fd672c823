"""The training cell: ``VMC.step`` of the program's VMC, driven as
``train.train`` drives it, in chunks of ``run.steps_per_dispatch`` steps with
the per-step key fold_in(base_key, step), each chunk ending when its metrics
are read to the host.

Set-up builds the VMC, puts the benchmark's weights in it, thermalizes
(``sampler.n_therm_sweeps`` of the configuration), moves the step counter
and the optimizer's count to the traffic's ``start_step`` (the diagonal
shift and the learning-rate schedule read them), then runs the traffic's
``check_steps`` through the window's own chunk call, keeping what the
correctness check reads; those steps also warm every shape up. The window
runs chunks until ``seconds`` have passed. After it, the reference follows
the checked steps.
"""
from __future__ import annotations

import gc
import time
import torch

from benchmark import check, devtrace
from benchmark.counts import flops
from benchmark.drivers import common
from benchmark.spans import Recorder, span_ms

def run_chunk(vmc, state, base_key: int, ids, n: int, rec: Recorder):
    """n steps, each marked at its start; returns (state, rows) with rows
    [energy_re, sr_iters] per step, read to the host at the chunk's end."""
    from qmcnn_tpu_torch.sampler.metropolis import fold_in

    metrics = []
    for _ in range(n):
        rec.step_start()
        state, mt = vmc.step(state, fold_in(base_key, state.step), ids)
        metrics.append(mt)
    rows = [[float(mt.energy_re), float(mt.energy_im), float(mt.energy_var),
             float(mt.accept_rate), float(mt.grad_norm), int(mt.sr_iters)]
            for mt in metrics]
    return state, rows


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, numbers: bool = True) -> dict:
    from qmcnn_tpu_torch.sampler.metropolis import fold_in, prng_key
    from qmcnn_tpu_torch.train import chunked_thermalize

    cfg, traffic = cell["config"], cell["traffic"]
    phases = common.Phases(t_start, device)
    vmc, _, params, dev = common.build(cfg, seed, device,
                                       cell.get("weight_std"))
    phases.mark("build")
    m = int(cfg["sampler"]["n_walkers"])
    key = prng_key(seed + 100)
    state = vmc.init_state(fold_in(key, 0), m, params, device=dev)
    ids = torch.arange(m, device=dev)
    state = chunked_thermalize(vmc, state, fold_in(key, 1), ids,
                               int(cfg["sampler"]["n_therm_sweeps"]),
                               int(cfg["run"]["therm_sweeps_per_dispatch"]))
    phases.mark("thermalize")
    start = int(traffic["start_step"])
    state = state._replace(step=start,
                           opt_state=dict(state.opt_state, count=start))
    rec = Recorder(cfg, dev)
    vmc = common.with_proxies(vmc, rec)
    base_key = fold_in(key, 2)

    rec.stash = {"params_in": [], "s_in": [], "s_out": [], "lp_out": []}
    state, rows = run_chunk(vmc, state, base_key, ids,
                            int(traffic["check_steps"]), rec)
    stash, rec.stash = rec.stash, None
    stash["energy"] = [r[0] for r in rows]
    checked_iters = [r[5] for r in rows]
    stash["params_out"] = {k: v.detach().clone()
                           for k, v in state.params.items()}
    common.sync(dev)
    phases.mark("checked_steps")
    setup_s = time.perf_counter() - t_start

    per = int(cfg["run"]["steps_per_dispatch"])
    rec.starts = []
    rec.spans = rec.counts = bool(trace)
    rec.spans = rec.spans and rec.cuda
    clock = common.Clock(dev)
    window = devtrace.TraceWindow(bool(trace), per)
    steps, window_rows = 0, []
    clock.start()
    while True:
        window.before(steps)
        state, rows = run_chunk(vmc, state, base_key, ids, per, rec)
        window_rows += rows
        steps += per
        done = clock.elapsed() >= seconds
        window.after(steps, done)
        if done:
            break
    rec.step_start()
    common.sync(dev)
    window_s = time.perf_counter() - clock.t0
    peak = common.memory_peak(dev)

    intervals = [a.elapsed_time(b) for a, b in zip(rec.starts[:-1],
                                                   rec.starts[1:])] \
        if rec.cuda else []
    run_rec = {
        "cell": cell["name"], "cfg": cfg, "seed": seed, "trace": bool(trace),
        "m": m, "setup_s": setup_s,
        "window_s": window_s, "steps": steps, "intervals_ms": intervals,
        "sr_iters": [r[5] for r in window_rows],
        "energies": [r[0] for r in window_rows],
        "memory_peak_bytes": peak, "setup_phases": phases.seconds,
        "diagnostics": {"sr_iters_mean": sum(r[5] for r in window_rows)
                        / max(len(window_rows), 1),
                        "checked_sr_iters": checked_iters},
    }
    if trace:
        summary = window.summary()
        sweep = [float(x) for x in rec.sweep_rows]
        nnz = [float(x) for x in rec.nnz]
        run_rec.update({
            "sampler_ms": span_ms(rec.sampler_ev),
            "sr_ms": span_ms(rec.sr_ev),
            "eval_rows": [flops.eval_rows(m, a, b)
                          for a, b in zip(sweep, nnz)],
            "traced_steps": window.units,
            "devtrace": summary,
            "step_flop": [flops.step_flop(cfg, m, a, b, it) for a, b, it
                          in zip(sweep, nnz, run_rec["sr_iters"])],
        })
        if summary is not None:
            run_rec["busy_s"] = summary["busy_s"]
            run_rec["trace_window_s"] = summary["window_s"]

    del state, vmc, rec
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    run_rec["stash"], run_rec["params"] = stash, params
    if numbers:
        t0 = time.perf_counter()
        run_rec["numbers"] = check.train_numbers(
            cfg, params, stash, start, start, run_rec["diagnostics"])
        run_rec["diagnostics"]["check_s"] = time.perf_counter() - t0
    return run_rec
