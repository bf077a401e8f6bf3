"""Configuration dataclasses: AMG / solver / problem parameter presets.

One typed config system replacing the reference's three tiers (SURVEY.md
§5.6): the haznics parameter dicts (/root/reference/src/amg_parameters.py),
the ``input_metric.dat`` key-value file, and per-driver argparse defaults.
The four canned presets reproduce the reference's, keyed by the same names
the drivers use (-precond hazmath / hazmath_Schwarz / hazmath_HEM /
metric / metric_mono / metric_hazmath).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class AMGParameters:
    """Mirror of the haznics AMG parameter surface actually used
    (/root/reference/src/amg_parameters.py:3-89, utils.py:20-38,60-82)."""
    amg_type: str = "ua"              # ua | sa            (UA_AMG/SA_AMG)
    cycle_type: str = "w"        # v | w | amli | nl_amli | add | fmg
    max_levels: int = 20
    maxit: int = 1                    # cycles per preconditioner apply
    smoother: str = "sgs"    # jacobi|l1_jacobi|gs|sgs|sor|ssor|chebyshev
    #                          (SOR/SSOR = relaxation-weighted multicolor
    #                          GS — HAZmath smoother enums 9/14,
    #                          /root/reference/src/amg_parameters.py:9)
    relaxation: float = 1.2
    presmooth_iter: int = 1
    postsmooth_iter: int = 1
    coarse_dof: int = 100
    coarse_solver: str = "dense"      # dense LU == UMFPACK role (32)
    coarse_scaling: bool = True
    aggregation_type: str = "vmb"     # vmb | hem | mis | mwm | hec
    strong_coupled: float = 0.1
    max_aggregation: int = 100
    amli_degree: int = 3
    # Schwarz smoother block (HAZmath Schwarz_*)
    schwarz_levels: int = 0           # levels 0..k-1 get Schwarz smoothing
    schwarz_mmsize: int = 100
    schwarz_maxlvl: int = 1
    schwarz_type: str = "symmetric"   # forward | backward | symmetric
    schwarz_blksolver: str = "dense"  # dense inverse == UMFPACK role
    schwarz_cluster: bool = False     # merge overlapping seed blocks
    #                                   into shared blocks (no reference
    #                                   analog; the cure for interface
    #                                   footprints denser than the bulk
    #                                   mesh — smoothers.schwarz_setup.
    #                                   merge_overlapping_blocks)
    # knobs with no reference analog
    dtype: str = "float64"            # device dtype for the cycle
    pairwise_passes: int = 2          # HEM matchings per level (ratio ~2^k)
    max_w_work: int = 64              # cap on W/AMLI recursive visits;
    #                                   deeper levels degrade to V
    gs_max_colors: int = 24           # multicolor-GS color cap; rows in
    #                                   the overflow group get l1-Jacobi
    #                                   damping.  Each color costs ~2
    #                                   gather/scatter ops per half
    #                                   sweep; smaller caps trade
    #                                   smoothing for fewer ops
    print_level: int = 0


# -- canned presets (parity with /root/reference/src/amg_parameters.py) ----

# Cycle deviation from the reference dict (amg_parameters.py:6 says
# W_CYCLE): our multicolor-GS UA W-cycle measured NOT h-robust at
# gamma=1 (18->39 iters over refinements even with max_w_work lifted
# and coarse_scaling implemented; scripts/exp_std_amg.py), overstating
# metric AMG's relative win.  NL_AMLI(2) — the K-cycle, also a HAZmath
# cycle_type — with coarse_scaling measures 15->19 iters / cond 5.3
# over 5 refinements (h-robust), the fair standard-AMG baseline.
parameters_standard = AMGParameters(
    amg_type="ua", cycle_type="nl_amli", amli_degree=2, max_levels=20,
    maxit=1, smoother="sgs",
    relaxation=1.2, coarse_dof=100, aggregation_type="vmb",
    strong_coupled=0.1, max_aggregation=100, schwarz_levels=0)

parameters_standard_schwarz = replace(
    parameters_standard, schwarz_levels=1, schwarz_mmsize=100,
    schwarz_maxlvl=1)

# Strict reference-parity variant of 'standard': the exact
# parameters_standard dict (amg_parameters.py:3-21) with W_CYCLE —
# kept for parity runs/experiments; the h-robust nl_amli variant above
# is the benchmark baseline (see the deviation note).
parameters_standard_reference = replace(
    parameters_standard, cycle_type="w", amli_degree=3)

parameters_metric = AMGParameters(
    amg_type="ua", cycle_type="w", max_levels=20, maxit=1, smoother="sgs",
    relaxation=1.2, coarse_dof=100, aggregation_type="hem",
    strong_coupled=0.1, amli_degree=3, schwarz_levels=0)

parameters_metric_schwarz = replace(
    parameters_metric, schwarz_levels=1, schwarz_mmsize=100,
    schwarz_maxlvl=1)

# default dict used by get_hazmath_metric_precond_mono when None
# (/root/reference/src/utils.py:60-82): metric + Schwarz with maxlvl 2
parameters_metric_mono_default = replace(
    parameters_metric_schwarz, schwarz_maxlvl=2)

# 3D-1D h-robust variant (round 5, scripts/exp_3d1d_hrobust.py): the
# input_metric.dat config (UA + V) grows 6->11->18 iters over
# mesh_n=8/16/32 at gamma=1 — piecewise-constant UA under a V-cycle is
# not h-optimal on the near-decoupled-Poisson regime.  Smoothed
# aggregation + NL-AMLI(2) + clustered footprint Schwarz measures
# 4->5->6 (cond <= 1.3): h-FLAT at gamma=1.  (At gamma=1e8 it is
# comparable to clu_mm, not flat — the extreme-gamma h-growth remains
# open.)
parameters_metric_3d1d_hrobust = AMGParameters(
    amg_type="sa", cycle_type="nl_amli", amli_degree=2, max_levels=30,
    maxit=1, smoother="gs", relaxation=1.0, coarse_dof=300,
    aggregation_type="hem", strong_coupled=0.0, max_aggregation=20,
    schwarz_levels=1, schwarz_mmsize=500, schwarz_maxlvl=2,
    schwarz_cluster=True, pairwise_passes=2)

PRESETS = {
    "standard": parameters_standard,
    "standard_reference": parameters_standard_reference,
    "standard_schwarz": parameters_standard_schwarz,
    "metric": parameters_metric,
    "metric_schwarz": parameters_metric_schwarz,
    "metric_mono_default": parameters_metric_mono_default,
    "metric_3d1d_hrobust": parameters_metric_3d1d_hrobust,
}


@dataclass(frozen=True)
class SolverConfig:
    """Outer Krylov configuration (cbc.block ConjGrad surface,
    /root/reference/src/bidomain_2d.py:205)."""
    method: str = "cg"                # cg | minres | gmres
    tolerance: float = 1e-8
    maxiter: int = 500
    restart: int = 30                 # gmres only
    # HAZmath linear_stop_type codes (input_metric.dat:54):
    # 1 ||r||/||b||, 2 ||r||_B/||r0||_B (preconditioned), 3 ||r||/||x||
    stop_type: int = 2
