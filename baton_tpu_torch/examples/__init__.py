"""The repository's example configurations, run by the port (each module
keeps its ``examples/`` counterpart's ``run()`` arguments)."""
