"""Shared experiment-driver scaffolding.

Reproduces the reference drivers' refinement loop + reporting contract
(/root/reference/src/bidomain_2d.py:105-278): argparse flags
``-nrefs -kappa1 -kappa2 -gamma -pdegree -precond -save``, KSP table
(ndofs, niters, cond, timeKSP, r, h), error table (H1 errors + observed
rates), colored incremental prints, and append-mode
``results/<example>/{iters,error}_*.txt`` files.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..io_utils import (print_red, print_green, print_blue,
                        tabulate_simple, ResultWriter)

HEADERS_KSP = ["ndofs", "niters", "cond", "timeKSP", "r", "h"]
HEADERS_ERROR = ["ndofs", "h", "|eu1|_1", "r|eu1|_1", "|eu2|_1", "r|eu2|_1"]


def standard_parser(default_precond, precond_choices):
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("-nrefs", type=int, default=1,
                   help="Number of mesh refinements")
    p.add_argument("-kappa1", type=float, default=2, help="Diffusion in 1")
    p.add_argument("-kappa2", type=float, default=3, help="Diffusion in 2")
    p.add_argument("-gamma", type=float, default=5,
                   help="Coupling strength")
    p.add_argument("-pdegree", type=int, default=1,
                   help="Polynomial degree in Pk discretization")
    p.add_argument("-precond", type=str, default=default_precond,
                   choices=precond_choices)
    p.add_argument("-save", type=int, default=0, help="Save graphics")
    p.add_argument("-dtype", type=str, default="float64",
                   choices=("float32", "float64"),
                   help="device dtype for the solve phase")
    p.add_argument("-timing_runs", type=int, default=1,
                   help="with 2+, re-run the solve warm and report the "
                        "last run's time as timeKSP (excludes XLA compile,"
                        " matching the reference's compute-only timings)")
    p.add_argument("-backend", type=str, default="algebraic",
                   choices=("algebraic", "grid"),
                   help="algebraic = general ELL hierarchy; grid = "
                        "gather-free structured-grid hierarchy")
    return p


class ExperimentTables:
    """Collect + emit the two result tables of every reference driver."""

    def __init__(self, result_dir, tag):
        self.table_ksp = []
        self.table_error = []
        os.makedirs(result_dir, exist_ok=True)
        self.it_writer = ResultWriter(
            os.path.join(result_dir, f"iters_{tag}.txt"), HEADERS_KSP)
        self.err_writer = ResultWriter(
            os.path.join(result_dir, f"error_{tag}.txt"), HEADERS_ERROR)
        self._errors0 = None
        self._h0 = None

    def add(self, ndofs, niters, cond, dt, r_norm, h, errors):
        errors = np.asarray(errors, dtype=np.float64)
        if self._errors0 is None:
            rates = [np.nan] * len(errors)
        else:
            rates = np.log(errors / self._errors0) / np.log(h / self._h0)
        self._errors0, self._h0 = errors, h

        ksp_row = (ndofs, niters, cond, dt, r_norm, h)
        self.table_ksp.append(ksp_row)
        self.it_writer.write_row(ksp_row)

        error_row = (ndofs, h) + tuple(
            v for pair in zip(errors, rates) for v in pair)
        self.table_error.append(error_row)
        self.err_writer.write_row(error_row)

    def show(self):
        print_blue(tabulate_simple(self.table_ksp, HEADERS_KSP))
        print_green(tabulate_simple(self.table_error, HEADERS_ERROR))
        print()


def config_tag(args):
    return (f"precond{args.precond}_kappa1{args.kappa1}"
            f"_kappa2{args.kappa2}_gamma{args.gamma}"
            f"_pdegree{args.pdegree}")
