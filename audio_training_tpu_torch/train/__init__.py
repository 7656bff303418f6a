"""Training support; so far what inference reads of a run directory: its
metadata and the port's own weights file."""
