"""Command-line interface: solve MPS files, inspect the environment.

Counterpart of ``python -m pycllp_tpu``.  Usage:

    python -m pycllp_tpu_torch solve problem.mps [--solver hsd] [--tol 1e-6]
    python -m pycllp_tpu_torch --device cpu solve problem.mps
    python -m pycllp_tpu_torch info

``--device`` (default ``cuda``) replaces the reference's ``--platform``:
a CUDA request without a card raises, as the library does.  ``solve``
prints the reference's JSON (status, objective, iterations) and exits 0
only on OPTIMAL; with ``--dtype`` unset the MPS data's float64 is the
compute dtype (the reference switches on x64 for the same effect).
``info`` only reports, so it runs without a card.
"""

from __future__ import annotations

import argparse
import json
import sys


def cmd_info(args) -> int:
    import torch

    import pycllp_tpu_torch as tt

    cuda = torch.cuda.is_available()
    print(f"pycllp_tpu_torch {tt.__version__}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, cuda available: {cuda}")
    names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())] if cuda else []
    print(f"devices: {names or 'none (CPU only)'}")
    print(f"solvers: {tt.available_solvers()}")
    return 0


def cmd_solve(args) -> int:
    import numpy as np

    import pycllp_tpu_torch as tt
    from pycllp_tpu_torch.io.mps import read_mps

    prob = read_mps(args.file)
    m, n = prob.shape
    print(f"{prob.name or args.file}: {m} rows, {n} cols", file=sys.stderr)
    solver = tt.get_solver(
        args.solver,
        tol=args.tol,
        maxiter=args.maxiter,
        dtype=args.dtype,
        finish_dtype=args.finish_dtype,
        device=args.device,
    )
    solver.init(prob.lp)
    sol = solver.solve()
    status = tt.Status(int(np.asarray(sol.status)))
    out = {
        "status": status.name,
        "objective": float(np.asarray(sol.objective)),
        "iterations": int(np.asarray(sol.iterations)),
    }
    if args.print_solution:
        out["x"] = {
            name: float(v)
            for name, v in zip(prob.col_names, np.asarray(sol.x))
        }
    print(json.dumps(out, indent=2))
    return 0 if status == tt.Status.OPTIMAL else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pycllp_tpu_torch")
    p.add_argument(
        "--device",
        default="cuda",
        help="where device solvers run: 'cuda' (default; raises without a card) or 'cpu'",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("info", help="environment and registry report")
    pi.set_defaults(fn=cmd_info)

    ps = sub.add_parser("solve", help="solve an MPS file")
    ps.add_argument("file")
    ps.add_argument("--solver", default="hsd")
    ps.add_argument("--tol", type=float, default=1e-6)
    ps.add_argument("--maxiter", type=int, default=100)
    ps.add_argument("--dtype", default=None)
    ps.add_argument("--finish-dtype", dest="finish_dtype", default=None)
    ps.add_argument("--print-solution", action="store_true")
    ps.set_defaults(fn=cmd_solve)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
