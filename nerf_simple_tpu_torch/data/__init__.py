"""Scene loading and device-resident ray sets."""
