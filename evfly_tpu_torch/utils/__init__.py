"""Host-side utilities (numpy)."""
