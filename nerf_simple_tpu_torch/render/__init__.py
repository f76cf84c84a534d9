"""Ray -> radiance rendering."""
