"""User-facing applications of the port."""
