"""The six examples of the JAX package's ``examples/`` on the port.

Each mirrors the reference's script of the same name (the same steps,
printed lines, arguments and defaults) and adds ``--device`` (default
``cuda``; ``cpu`` runs it on the host):

    python -m repro_torch.examples.quickstart [--device cpu]
    python -m repro_torch.examples.pendulum_certificate
    python -m repro_torch.examples.serve_custom_formats
    python -m repro_torch.examples.serve_certified --precision-k 12
    python -m repro_torch.examples.serve_certified_lm [--formats]
    python -m repro_torch.examples.lm_precision_analysis

``main(argv)`` of each returns what it printed, as a dict, for callers
that check it.
"""
