"""Ray, sampling, encoding and compositing ops (torch)."""
