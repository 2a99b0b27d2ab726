"""Command-line entry points of the port (`python -m gedepth_tpu_torch.tools.<name>`)."""
