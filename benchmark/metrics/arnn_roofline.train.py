"""arnn_roofline.train: the ARNN trunk's share of its roofline. 100 x the
least time (``counts/peaks.roofline_seconds`` at the float32 peak) of the
log-psi forwards the traced steps needed, over the device seconds of the
program's ``arnn`` spans in them. The forwards needed are counted from the
inputs: each step's evaluation rows (``counts/flops.eval_rows``) less the
direct pass's m N conditional rows, which the sampler's counts hold in
their place (its closing log psi of the m walkers stands where a refresh
would), and 2 m more, the gradient's and the score Jacobian's; each costs
``forward_flop`` and ``forward_bytes``. The conditional forwards are left
out of both sides: a pass that reuses what earlier sites computed needs far
less than one forward a site. None where the program records no ``arnn``
span."""
from benchmark import program_spans
from benchmark.counts import flops, peaks


def read(run):
    if "steps" not in run or not run.get("eval_rows"):
        return None
    a, b = run.get("traced_steps", (0, 0))
    spans = [sp for sp in program_spans.recorded() or ()
             if sp.name == "arnn"]
    if not spans or b <= a:
        return None
    ms = [sp.device_ms() for sp in spans]
    if any(x is None for x in ms) or sum(ms) <= 0:
        return None
    cfg, m = run["cfg"], run["m"]
    passes = m * flops.n_sites(cfg) * int(cfg["sampler"]["n_sweeps_per_step"])
    rows = sum(run["eval_rows"][a:b]) + (2.0 * m - passes) * (b - a)
    bound = peaks.roofline_seconds(rows * flops.forward_flop(cfg),
                                   rows * flops.forward_bytes(cfg),
                                   "float32")
    return 100.0 * bound / (sum(ms) / 1e3)
