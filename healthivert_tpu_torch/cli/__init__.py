"""The port's command-line entry points: `python -m healthivert_tpu_torch.cli.<name>`."""
