"""Command-line entry points of the port.

    python -m passiveradar_torch.cli.process --config cfg.yaml [--device cpu]
"""
