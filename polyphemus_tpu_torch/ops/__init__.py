from . import lattice, masked  # noqa: F401
