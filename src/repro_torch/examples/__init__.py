"""The port's FAME entry points: the counterparts of the JAX package's
``examples/`` scripts, runnable as ``python -m repro_torch.examples.<name>``
(``quickstart``, ``serve_agents``, ``research_summary``,
``log_analytics``). Each takes the JAX script's flags and defaults plus
``--device`` (default ``cuda``; ``--device cpu`` runs the port's plain
kernel versions on the CPU), and exposes the functions behind its CLI so
a caller can run them on a server it built itself."""
