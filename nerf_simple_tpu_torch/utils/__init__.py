"""Host-side helpers of the port (PNG IO, logging)."""
