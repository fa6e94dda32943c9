"""The solvers the benchmark drives and checks, one module each, found by a
configuration's ``solver`` name."""
