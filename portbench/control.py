"""Readings of the comparison that decides `correct`, for the program and for
its control, on the first requests of many seeds in one process (the
program's set-up made once): the readings that each cell's limit in
`limits/<cell>.json` is set from.

    python3 -m portbench.control --workload <cell> --seeds 1 2 3 [--requests 4] \
        [--program 1] [--control 1]

For each seed: the first `--requests` requests of the window's stream, their
answers from the program's route (as a run computes them) and from the
control, the reference computed in TF32 (reference/control.py), each judged
against the reference as a run judges it. Prints one JSON line per seed with
the largest reading of each side, and a summary line.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--program", type=int, default=1)
    p.add_argument("--control", type=int, default=1)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import importlib

    import torch

    from portbench import spec, traffic
    from portbench.reference import checks, family
    from portbench.routes import dtype_of

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    kind, mesh = cell.limits["check"], cell.config["mesh"]
    check = checks.kind(kind, cell.config, cell.mix)
    make = traffic.StateMaker(cell.config, family(mesh).cell_centres(mesh), device,
                              dtype_of(cell.config))
    inputs = {}
    for seed in args.seeds:
        reqs = traffic.Requests(cell.mix, cell.config, seed, traffic.WINDOW)
        inputs[seed] = [make(*reqs.next()) for _ in range(args.requests)]
    answers = {seed: {} for seed in args.seeds}
    if args.program:
        route = importlib.import_module(f"portbench.routes.{cell.mix['route']}").build(
            cell.config, cell.mix, device)
        warm = traffic.Requests(cell.mix, cell.config, args.seeds[0], traffic.WARMUP)
        for _ in range(int(cell.mix["warm_requests"])):
            route(make(*warm.next()))
        for seed in args.seeds:
            answers[seed]["program"] = np.stack(
                [route(U0)[0].double().cpu().numpy() for U0 in inputs[seed]], axis=1)
        route.release()
        del route
    host = {seed: np.stack([u.double().cpu().numpy() for u in inputs[seed]], axis=1)
            for seed in args.seeds}
    del inputs, make
    if device.type == "cuda":
        torch.cuda.empty_cache()
    summary = {"program": [], "control": []}
    for seed in args.seeds:
        u0 = host[seed]
        if args.control:
            answers[seed]["control"] = check.control(u0, device)
        ref = check.answers(u0, device)
        line = {"seed": seed}
        for side, u1 in answers[seed].items():
            line[side] = float(max(check.readings(u1, ref)))
            summary[side].append(line[side])
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": cell.name, "check": kind, "requests": args.requests,
                      "program_max": max(summary["program"], default=None),
                      "control_min": min(summary["control"], default=None)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
