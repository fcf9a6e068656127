"""Command-line entry points of the port (``--device cpu`` for the CPU).

    python -m passiveradar_torch.cli.process --config cfg.yaml
    python -m passiveradar_torch.cli.preview --config cfg.yaml
    python -m passiveradar_torch.cli.stream --config cfg.yaml
    python -m passiveradar_torch.cli.plot --config cfg.yaml --mode frames
    python -m passiveradar_torch.cli.track_multi --config cfg.yaml
    python -m passiveradar_torch.cli.track_simple --config cfg.yaml
    python -m passiveradar_torch.cli.wideband --config wide.yaml --integrate
"""
