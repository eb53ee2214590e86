"""Matrix generators, one module a configuration family.

Each module defines ``generate(cfg, rng) -> Csr``: the configuration's
matrix as plain NumPy CSR arrays, made from the configuration file's sizes
and, where the source draws at random, from ``rng`` (a
``numpy.random.Generator`` seeded by the run's ``--seed``).  A
configuration names its module under ``"generator"``.
"""
