"""The benchmark harness: registry, runner, device corpus, trace reading."""
