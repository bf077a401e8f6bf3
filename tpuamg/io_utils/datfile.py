"""Parser for HAZmath-style ``.dat`` solver input files.

The reference's offline 3D-1D solver is configured by
``/root/reference/src/input_metric.dat`` — a ``key = value %comment``
format parsed in C.  This parser maps the used keys onto our
AMGParameters/SolverConfig so the same input files drive this build
(run_solver_3d1d.py parity).
"""
from __future__ import annotations

from dataclasses import replace

from ..config import AMGParameters, SolverConfig

# value maps accept both the symbolic names used in .dat files
# (input_metric.dat:51-100) and haznics integer enum codes
_CYCLE = {"V": "v", "W": "w", "A": "amli", "NA": "nl_amli", "ADD": "add",
          0: "v", 1: "v", 2: "w", 3: "amli", 4: "nl_amli", 12: "add"}
_AMG_TYPE = {"UA": "ua", "SA": "sa", "MUA": "ua", "MSA": "sa",
             1: "ua", 2: "sa"}   # MUA/MSA = metric variants: same builder,
#                                  metric behavior comes via idofs
_SMOOTHER = {"JACOBI": "jacobi", "GS": "gs", "SGS": "sgs", "SOR": "sor",
             "SSOR": "ssor", "L1DIAG": "l1_jacobi", "CHEBY": "chebyshev",
             1: "jacobi", 2: "gs", 3: "sgs", 4: "chebyshev"}
_KRYLOV = {1: "cg", 2: "minres", 3: "gmres"}
# numeric codes follow HAZmath's enum ("1 VMB ; 4 HEC",
# /root/reference/src/input_metric.dat:89); symbolic names also accepted
_AGG = {1: "vmb", 2: "mis", 3: "mwm", 4: "hec", 5: "hem",
        "VMB": "vmb", "MIS": "mis", "MWM": "mwm", "HEM": "hem",
        "HEC": "hec"}


def parse_dat_file(path):
    """Return dict of raw key -> value (int/float/str)."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("%")[0].strip().rstrip(";")
            if not line or "=" not in line:
                continue
            key, val = (s.strip() for s in line.split("=", 1))
            val = val.rstrip(";").strip()
            try:
                out[key] = int(val)
            except ValueError:
                try:
                    out[key] = float(val)
                except ValueError:
                    out[key] = val
    return out


def dat_to_amg_parameters(path):
    """(AMGParameters, SolverConfig) from a HAZmath .dat file
    (input_metric.dat keys; SURVEY.md §5.6c)."""
    raw = parse_dat_file(path)
    amg = AMGParameters(
        amg_type=_AMG_TYPE.get(raw.get("AMG_type", 1), "ua"),
        cycle_type=_CYCLE.get(raw.get("AMG_cycle_type", 1), "v"),
        max_levels=raw.get("AMG_levels", 20),
        smoother=_SMOOTHER.get(raw.get("AMG_smoother", 3), "sgs"),
        relaxation=raw.get("AMG_relaxation", 1.2),
        presmooth_iter=raw.get("AMG_presmooth_iter", 1),
        postsmooth_iter=raw.get("AMG_postsmooth_iter", 1),
        coarse_dof=raw.get("AMG_coarse_dof", 100),
        strong_coupled=raw.get("AMG_strong_coupled", 0.1),
        max_aggregation=raw.get("AMG_max_aggregation", 100),
        amli_degree=raw.get("AMG_amli_degree", 3),
        aggregation_type=_AGG.get(raw.get("AMG_aggregation_type", 1),
                                  "vmb"),
        # missing-key default OFF: the reference's input_metric.dat:83
        # sets OFF explicitly (and its dict presets set ON explicitly),
        # so an unspecified .dat key conservatively matches the dat file
        coarse_scaling=str(raw.get("AMG_coarse_scaling", "OFF")
                           ).upper() in ("ON", "1", "TRUE"),
        schwarz_levels=raw.get("AMG_Schwarz_levels", 0),
        schwarz_mmsize=raw.get("Schwarz_mmsize", 200),
        schwarz_maxlvl=raw.get("Schwarz_maxlvl", 2),
        schwarz_type={1: "forward", 2: "backward", 3: "symmetric"}.get(
            raw.get("Schwarz_type", 3), "symmetric"),
        print_level=raw.get("print_level", 0),
    )
    sol = SolverConfig(
        method=_KRYLOV.get(raw.get("linear_itsolver_type", 1), "cg"),
        tolerance=raw.get("linear_itsolver_tol", 1e-6),
        maxiter=raw.get("linear_itsolver_maxit", 1000),
        stop_type=raw.get("linear_stop_type", 1),
    )
    return amg, sol
