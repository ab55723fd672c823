"""The measurement cell: the loop that ``measure.measure`` runs, per sample
``sweeps_between`` sweeps of the program's sampler (``VMC.thermalize``)
and ``measure.sample_estimators`` on the physical walkers through
``VMC.eval_log_psi_fn``, each sample's answers read to the host.

Set-up builds the VMC in float32 with the benchmark's weights, thermalizes
``therm_sweeps`` sweeps and measures ``warm_samples`` samples, which warm
every shape up. The window measures until ``seconds`` have passed. A sample
is checked when a hash of the seed and its index falls under
``check_share`` (and the window's first sample always); its walkers and
answers are kept, and after the window the
reference works the answers out again from those walkers. The S.S rows and
the estimators are the square lattice's, so another lattice is refused.
"""
from __future__ import annotations

import gc
import random
import time
import numpy as np
import torch

from benchmark import check, devtrace
from benchmark.counts import flops
from benchmark.drivers import common
from benchmark.reference import estimators, hamiltonian
from benchmark.spans import Recorder

def checked(seed: int, index: int, share: float) -> bool:
    return random.Random(seed * 1_000_003 + index).random() < share


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, numbers: bool = True) -> dict:
    estimators.square_only(cell["config"])
    from qmcnn_tpu_torch.measure import chunk_sizes, sample_estimators
    from qmcnn_tpu_torch.sampler.metropolis import fold_in, prng_key
    from qmcnn_tpu_torch.train import chunked_thermalize

    cfg, traffic = cell["config"], cell["traffic"]
    phases = common.Phases(t_start, device)
    vmc, lattice, params, dev = common.build(cfg, seed, device,
                                              std=cell.get("weight_std"))
    phases.mark("build")
    m = int(cfg["sampler"]["n_walkers"])
    key = prng_key(seed + 12345)
    ids = torch.arange(m, device=dev)
    state = vmc.init_state(fold_in(key, 0), m, params, device=dev)
    state = chunked_thermalize(vmc, state, fold_in(key, 1), ids,
                               int(traffic["therm_sweeps"]),
                               int(cfg["run"]["therm_sweeps_per_dispatch"]))
    phases.mark("thermalize")
    rec = Recorder(cfg, dev)
    vmc = common.with_proxies(vmc, rec)
    le_chunk = chunk_sizes(vmc, m, lattice)[0]
    marshall = (cfg["hamiltonian"]["kind"] in ("heisenberg", "j1j2")
                and bool(cfg["hamiltonian"]["marshall"]))
    between = int(traffic["sweeps_between"])
    pairs = torch.as_tensor(hamiltonian.bonds(cfg)[0], device=dev)
    x_bonds = pairs[0:2 * int(np.prod(cfg["lattice"]["shape"])):2]

    def one_sample(state, i: int, keep: bool):
        s_in = state.walkers.s.clone() if keep else None
        state = vmc.thermalize(state, fold_in(key, 100 + i), ids,
                               n_sweeps=between)
        walkers = vmc.sampler.physical(state.walkers)
        est = sample_estimators(vmc.eval_log_psi_fn, state.params, walkers,
                                vmc.ham, lattice, chunk_size=le_chunk,
                                dimer=False, marshall=marshall, group=None)
        answers = {k: (v.cpu().numpy() if v.dim() else float(v))
                   for k, v in est.items()}
        if rec.counts:
            rec.nnz[-1] = rec.nnz[-1] + hamiltonian.anti_aligned(
                walkers.s, x_bonds).sum()
        if keep:
            stash["params_in"].append(state.params)
            stash["s_in"].append(s_in)
            stash["s_out"].append(walkers.s.clone())
            stash["lp_out"].append((walkers.log_psi.re.clone(),
                                    walkers.log_psi.im.clone()))
            stash["answers"].append(answers)
        return state, answers

    stash = {"params_in": [], "s_in": [], "s_out": [], "lp_out": [],
             "answers": []}
    index = 0
    for _ in range(int(traffic["warm_samples"])):
        state, _ = one_sample(state, index, False)
        index += 1
    common.sync(dev)
    phases.mark("warm_samples")
    setup_s = time.perf_counter() - t_start

    share = float(traffic["check_share"])
    rec.spans = rec.counts = bool(trace)
    rec.spans = rec.spans and rec.cuda
    clock = common.Clock(dev)
    window = devtrace.TraceWindow(bool(trace), 1)
    samples, energies = 0, []
    clock.start()
    while True:
        window.before(samples)
        state, answers = one_sample(
            state, index, samples == 0 or checked(seed, index, share))
        energies.append(answers["energy"])
        index += 1
        samples += 1
        done = clock.elapsed() >= seconds
        window.after(samples, done)
        if done:
            break
    common.sync(dev)
    window_s = time.perf_counter() - clock.t0
    peak = common.memory_peak(dev)
    run_rec = {
        "cell": cell["name"], "cfg": cfg, "seed": seed, "trace": bool(trace),
        "m": m, "setup_s": setup_s,
        "window_s": window_s, "samples": samples, "energies": energies,
        "checked_samples": len(stash["answers"]),
        "memory_peak_bytes": peak, "setup_phases": phases.seconds,
    }
    if trace:
        summary = window.summary()
        sweep = [float(x) for x in rec.sweep_rows]
        nnz = [float(x) for x in rec.nnz]
        run_rec.update({
            "eval_rows": [flops.eval_rows(m, a, b)
                          for a, b in zip(sweep, nnz)],
            "traced_steps": window.units, "devtrace": summary,
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
        run_rec["numbers"] = check.measure_numbers(cfg, params, stash)
    return run_rec
