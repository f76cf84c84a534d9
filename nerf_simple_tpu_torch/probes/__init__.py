"""Measurement probes of the card (each with its kernel in ``csrc/``)."""
