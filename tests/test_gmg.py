"""GMG comparison-path tests (reference bidomain_2d_firedrake.py).

Covers both -mg_type modes and both mg smoothers of the driver, with the
full-MG (F-cycle) application and MMS rate checks — the verification the
reference builds into its drivers (SURVEY.md §4.1-4.2).
"""
import numpy as np
import pytest

from tpuamg.problems.bidomain_2d_gmg import main as gmg_main


def _run(argv):
    tables = gmg_main(argv)
    ksp = np.asarray([[r[0], r[1], r[3]] for r in tables.table_ksp])
    err = tables.table_error
    return ksp, err


@pytest.mark.parametrize("gamma", ["1", "100000000"])
def test_gmg_fullmg_cheb(gamma):
    """Geometric full-MG hierarchy + nodal Chebyshev, gamma sweep ends.

    GMG is the reference's DEGRADING comparison baseline (the paper's
    point is that metric AMG beats it at large gamma), so at gamma=1e8
    we assert convergence + clean MMS rates, not robust counts."""
    ksp, err = _run(["-nrefs", "3", "-gamma", gamma, "-mg_type", "mg",
                     "-smoother", "cheb"])
    niters = ksp[:, 1]
    assert np.all(niters <= 30), niters
    # h-robustness (AMLI-accelerated window hierarchy): a plateau —
    # growth over refinements stays below 1.4x and
    # the last refinement adds at most one iteration over the previous
    # (committed nrefs-5 tables show 11->15 flat; the round-3 1.35x
    # bound was written against the AMLI(3) variant and off by 0.15 it)
    assert niters[-1] <= 1.4 * max(niters[0], 8), niters
    assert niters[-1] <= niters[-2] + 1, niters
    # MMS rate ~ 1 (P1) on the finest refinement; the strip-consistent
    # MMS keeps this clean at every gamma
    rate = err[-1][3]
    assert 0.8 < rate < 1.3, rate


def test_gmg_fullmg_patch():
    """Full-MG + vertex-star patch smoother (PatchPC analog)."""
    ksp, err = _run(["-nrefs", "2", "-gamma", "10000", "-mg_type", "mg",
                     "-smoother", "patch"])
    assert np.all(ksp[:, 1] <= 60), ksp[:, 1]
    rate = err[-1][3]
    assert 0.8 < rate < 1.3, rate


def test_gmg_amg_mode():
    """-mg_type amg = the hypre-BoomerAMG comparison role."""
    ksp, err = _run(["-nrefs", "2", "-gamma", "1", "-mg_type", "amg"])
    assert np.all(ksp[:, 1] <= 80), ksp[:, 1]
    rate = err[-1][3]
    assert 0.8 < rate < 1.3, rate
