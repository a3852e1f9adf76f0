"""The benchmark's own tests: ``python -m pytest v2vbench/tests -q`` from the
root of the repository. Tests marked ``card`` need a CUDA card and skip
without one; on a machine with one and without JAX (which the repository's
root conftest imports), ``python -m pytest v2vbench/tests -q -m card
--noconftest`` runs them."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
