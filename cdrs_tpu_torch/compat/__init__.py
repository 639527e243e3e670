"""The reference user's call signatures on the port (``reference_api``)."""
