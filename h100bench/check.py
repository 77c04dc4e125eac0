"""The comparison that decides ``correct``.

Each solve is an answer that can be checked by what it says.  For every
solve in the run's sample (drawn from the seed), with the plain reference
that the configuration names (``references/<reference>.py``), on the (n+1)^d
node grid cut from the padded arrays:

* ``rel_res``: ||b - A u||_2 / ||b||_2 in float64, u the sum of the
  program's output parts (u_hi + u_lo for a refined solve), A the
  reference's own operator;
* ``u_gap``: max |u - u_ref| / max |u_ref|, u_ref the reference's own
  float64 run of the same cycles from the same b (fixed-cycle traffic).

The largest value over the sample is compared with the cell's limit
(``limits/<cell>.json``).  :func:`control` puts the reference in the
program's place, in the lower precision the cell's limits file names, to
show that the limits fail it.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent


def reference(config: dict, dtype, device):
    """The configuration's plain reference solver in ``dtype``."""
    path = BENCH / "references" / f"{config['reference']}.py"
    spec = importlib.util.spec_from_file_location(
        "h100bench_reference_" + config["reference"], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.Reference(config, dtype, device)


def nodes(x, n: int):
    """The (n+1)^d node grid of a padded array."""
    return x[(slice(0, n + 1),) * x.ndim]


def measure(ref64, traffic: dict, names, b, parts, cache=None) -> dict:
    """The compared numbers of one answer ``parts`` to right-hand side
    ``b`` (both on the node grid).  ``cache`` keeps the reference's own
    answers by right-hand side."""
    b64 = b.double()
    u = parts[0].double()
    for p in parts[1:]:
        u = u + p.double()
    out = {}
    if "rel_res" in names:
        out["rel_res"] = float(_norm(ref64.residual(u, b64)) / _norm(b64))
    if "u_gap" in names:
        cache = {} if cache is None else cache
        key = b.data_ptr()
        if key not in cache:
            cache[key] = ref64.cycles(b64, traffic["cycles"])
        want = cache[key]
        out["u_gap"] = float((u - want).abs().max() / want.abs().max())
    return out


def _norm(x):
    return torch.sqrt(torch.sum(x * x))


def compare(config: dict, traffic: dict, limits: dict, pool, sample,
            device) -> dict:
    """{name: {"value", "limit"}} over the sampled solves: the largest
    value of each compared number."""
    n = config["levels"][0][0]
    names = list(limits["compare"])
    ref64 = reference(config, torch.float64, device)
    worst = {k: 0.0 for k in names}
    cache = {}
    for _, j, parts in sample:
        got = measure(ref64, traffic, names, nodes(pool[j], n),
                      [nodes(p, n) for p in parts], cache)
        for k, v in got.items():
            # A NaN answer is as wrong as it gets.
            worst[k] = float("inf") if v != v else max(worst[k], v)
    return {k: {"value": worst[k], "limit": limits["compare"][k]["limit"]}
            for k in names}


def control(config: dict, traffic: dict, limits: dict, b, device) -> dict:
    """The reference in the program's place, in the lower precision that the
    cell's limits name (``control_dtype``): its compared numbers for the
    right-hand side ``b`` (a padded array, as the program takes it)."""
    n = config["levels"][0][0]
    low = getattr(torch, limits["control_dtype"])
    ref = reference(config, low, device)
    bn = nodes(b, n)
    if "tol" in traffic:
        u = ref.refine(bn.to(low), traffic["tol"], traffic["max_iters"])
    else:
        u = ref.cycles(bn.to(low), traffic["cycles"])
    del ref
    return measure(reference(config, torch.float64, device), traffic,
                   list(limits["compare"]), bn, [u])
