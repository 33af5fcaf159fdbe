"""One driver per kind of trainer, ``<kind>.py`` with ``prepare(spec)`` (run
once in the first process, before any rank starts) and ``run_rank(spec,
rank, world)`` (the exit code; rank 0 prints the result)."""
