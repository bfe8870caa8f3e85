"""Compute ops. The package ``__init__`` imports the submodules; this
file imports none, so ``core`` can use ``ops.linalg`` without a cycle."""
