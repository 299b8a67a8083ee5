"""cfdtpu_torch CLI: the `simulate` subcommand of cfdtpu's main.py.

    python -m cfdtpu_torch simulate --simulation dfg_1 \\
        --solver stabilized_schur --T 0.1 --dt 0.05 --name run \\
        --res_scale 0.3 [--device cpu] [--key value ...]

It runs on the CUDA card unless --device cpu is given; with no card and
no --device it prints the error and exits with 1.

Unknown --key value pairs are literal-eval'd and forwarded through
Simulation -> Scenario -> Solver constructors, each layer keeping only
the kwargs its signature declares (as in cfdtpu's main.py).
"""

import argparse
import ast
import sys


def parse_unknown_args(tokens):
    """Freeform `--key value` / `--key=value` / bare `--flag` pairs to a
    kwargs dict, values literal-eval'd when they parse (ints, floats,
    tuples, quoted strings) and kept verbatim otherwise."""
    out = {}
    it = iter(range(len(tokens)))
    for i in it:
        tok = tokens[i]
        if not tok.startswith("--"):
            continue
        body = tok[2:]
        if "=" in body:
            key, _, raw = body.partition("=")
        elif i + 1 < len(tokens) and not tokens[i + 1].startswith("--"):
            key, raw = body, tokens[i + 1]
            next(it, None)  # consume the value token
        else:
            key, raw = body, True
        if isinstance(raw, str):
            try:
                raw = ast.literal_eval(raw)
            except (ValueError, SyntaxError):
                pass  # verbatim string (scenario / solver names etc.)
        out[key] = raw
    return out


def run_simulate(args, unknown):
    """Run a single CFD simulation."""
    from cfdtpu_torch.simulation import Simulation

    kwargs = parse_unknown_args(unknown)
    # optional physics flags ride along only when given, so scenario
    # defaults stay in charge otherwise
    kwargs.update({
        k: v
        for k, v in (("mu", args.mu), ("rho", args.rho),
                     ("p_grade", args.p_grade))
        if v is not None
    })
    kwargs["device"] = args.device
    print(f"Running simulation with extra args: {kwargs}")

    try:
        sim = Simulation(
            name=args.name,
            simulation=args.simulation,
            solver=args.solver,
            T=args.T,
            dt=args.dt,
            output_dir=args.output_dir,
            early_stop_tolerance=args.early_stop_tolerance,
            **kwargs,
        )
    except (ValueError, ImportError, RuntimeError) as e:
        label = {
            ValueError: "Invalid configuration",
            ImportError: "Failed to load module",
            RuntimeError: "Initialization failed",
        }.get(type(e), type(e).__name__)
        print(f"\n[ERROR] {label}: {e}")
        return 1

    try:
        sim.run()
    except Exception as e:
        print(f"\n[ERROR] Simulation failed: {type(e).__name__}: {e}")
        raise
    return 0


_SIMULATE_FLAGS = [
    ("--simulation", dict(required=True,
                          help="Scenario name (e.g. dfg_1)")),
    ("--solver", dict(required=True,
                      help="Solver name (e.g. stabilized_schur)")),
    ("--mu", dict(type=float, default=None, help="Viscosity")),
    ("--rho", dict(type=float, default=None, help="Density")),
    ("--T", dict(type=float, required=True, help="Total time")),
    ("--dt", dict(type=float, required=True, help="Time step")),
    ("--name", dict(default="run", help="Name of the run")),
    ("--output_dir", dict(default="results", help="Output directory")),
    ("--early_stop_tolerance", dict(
        type=float, default=1e-5,
        help="Tolerance for early stopping the simulation")),
    ("--p_grade", dict(type=int, default=None,
                       help="Polynomial degree for velocity and pressure "
                            "spaces (default: 1)")),
    ("--device", dict(default="cuda",
                      help="torch device: cuda (the default; without a "
                           "card it is an error) or cpu")),
]


def build_parser():
    parser = argparse.ArgumentParser(
        prog="python -m cfdtpu_torch",
        description="cfdtpu_torch - hemodynamic CFD on PyTorch/CUDA",
    )
    sub = parser.add_subparsers(dest="command", help="Command")
    sim_p = sub.add_parser("simulate", help="Run a CFD simulation")
    for name, kw in _SIMULATE_FLAGS:
        sim_p.add_argument(name, **kw)
    return parser


def main(argv=None):
    parser = build_parser()
    args, unknown = parser.parse_known_args(argv)
    if args.command != "simulate":
        parser.print_help()
        return 1
    return run_simulate(args, unknown)


if __name__ == "__main__":
    sys.exit(main() or 0)
