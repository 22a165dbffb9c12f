"""repro_torch.launch — the training CLI (``python -m repro_torch.launch.train``)."""
