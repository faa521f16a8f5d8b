"""Measurement scripts for the card, run as modules from the root of a
checkout (``python -m pointvit_tpu_torch.tools.<name>``); importing them
does nothing."""
