"""Single-host IVI core: types, Dirichlet math, the E-step contract, the
memo store, the bound and the engine."""
