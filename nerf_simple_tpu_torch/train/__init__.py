"""Params IO. The training loop is not ported yet."""
